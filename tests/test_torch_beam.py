"""The port's beam search (Engine.generate_beam and the caches' reorder,
CPU) against the JAX package's, mirroring tests/test_beam_search.py.

The beams live as batch rows; every step advances them (log-softmax,
finished beams emit only EOS, top nb of nb * V continuations per
request) and reorders the caches by parent, in place and below the
decode's fill bound (the step a CUDA graph captures on the card).
Tolerance: tokens equal (f32 weights over f32 caches on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving.engine import Engine

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _exact_matmul():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", torch.float32)


def _kw(bits, W=32):
    return dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=W,
                scale_dtype="float32")


def _engines(bits, batch, W=32, debug=False):
    jp, tp = _params()
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**_kw(bits, W)),
                   params=jp, max_seq_len=128, batch_size=batch, impl="jnp")
    jeng.cache_dtype = jnp.float32
    teng = Engine(cfg=tiny_config(), qcfg=QuantConfig(**_kw(bits, W)),
                  params=tp, max_seq_len=128, batch_size=batch, device="cpu",
                  cache_dtype=torch.float32, debug=debug)
    return jeng, teng


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape)


@pytest.mark.parametrize("bits,nb,new", [(16, 2, 20), (2, 2, 40),
                                         (4, 3, 30)])
def test_beam_matches_jax(bits, nb, new):
    """Beam search over the fp16 cache and KIVI caches, with flushes
    crossing (30 prompt tokens, W 32): the best beams equal the JAX
    engine's."""
    jeng, teng = _engines(bits, 2 * nb)
    toks = _toks(bits + nb, (2, 30))
    want = np.asarray(jeng.generate_beam(jnp.asarray(toks, jnp.int32), new,
                                         num_beams=nb))
    got = teng.generate_beam(torch.from_numpy(toks), new, num_beams=nb)
    assert got.dtype == torch.int32 and got.shape == (2, new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_with_eos_and_length_penalty_matches_jax():
    """An EOS taken from the greedy stream, so beams finish mid-way (they
    then emit only EOS at no cost) and the length penalty ranks them."""
    jeng, teng = _engines(2, 4)
    toks = _toks(40, (2, 20))
    eos = int(teng.generate(torch.from_numpy(np.repeat(toks, 2, 0)),
                            8)[0, 3])
    want = np.asarray(jeng.generate_beam(jnp.asarray(toks, jnp.int32), 16,
                                         num_beams=2, eos_token_id=eos,
                                         length_penalty=0.7))
    got = teng.generate_beam(torch.from_numpy(toks), 16, num_beams=2,
                             eos_token_id=eos, length_penalty=0.7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [16, 2])
def test_beam1_matches_greedy(bits):
    """num_beams=1 beam search is greedy decoding."""
    _, teng = _engines(bits, 2)
    toks = torch.from_numpy(_toks(0, (2, 12)))
    greedy = teng.generate(toks, 40)
    beam = teng.generate_beam(toks, 40, num_beams=1)
    np.testing.assert_array_equal(beam.numpy(), greedy.numpy())


def test_beam_score_at_least_greedy():
    """The best beam's total log-probability is at least the greedy
    path's (fp16 cache, scored by one-shot prefill)."""
    _, eng1 = _engines(16, 1)
    _, eng4 = _engines(16, 4)
    toks = torch.from_numpy(_toks(1, (1, 8)))
    new = 8

    def path_logprob(seq):
        full = torch.cat([toks, seq.to(toks.dtype)], 1)
        caches = eng1.init_caches()
        T = full.shape[1]
        logits, _ = modeling.forward(eng1.params, full, caches, eng1.cfg,
                                     eng1.qcfg, torch.arange(T)[None],
                                     mode="prefill")
        lp = torch.log_softmax(logits.float(), -1)
        src = lp[:, toks.shape[1] - 1:-1]
        return float(src.gather(-1, full[:, toks.shape[1]:, None]).sum())

    greedy = eng1.generate(toks, new)
    beam = eng4.generate_beam(toks, new, num_beams=4)
    assert path_logprob(beam) >= path_logprob(greedy) - 1e-3


def test_beam_padded_matches_unpadded_fp16():
    """Left-padded beam search equals unpadded (the pad mask survives the
    per-step reorder)."""
    _, teng = _engines(16, 3)
    prompt = _toks(2, (1, 20))
    want = teng.generate_beam(torch.from_numpy(prompt), 6, num_beams=3)
    padded = np.concatenate([np.zeros((1, 7), np.int64), prompt], 1)
    got = teng.generate_beam(torch.from_numpy(padded), 6, num_beams=3,
                             pad_lens=[7])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bits", [16, 2])
def test_beam_with_prefix(bits):
    """Beam search behind a shared prefix: equals the JAX engine's; on
    the fp16 cache (an exact extend) also the full-prompt run."""
    jeng, teng = _engines(bits, 4)
    pre, suf = _toks(4, (20,)), _toks(5, (2, 8))
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    want = np.asarray(jeng.generate_beam(jnp.asarray(suf, jnp.int32), 10,
                                         num_beams=2, prefix=js))
    snap = teng.prefill_prefix(torch.from_numpy(pre))
    got = teng.generate_beam(torch.from_numpy(suf), 10, num_beams=2,
                             prefix=snap)
    np.testing.assert_array_equal(got.numpy(), want)
    if bits == 16:
        full = np.concatenate([np.broadcast_to(pre, (2, 20)), suf], 1)
        np.testing.assert_array_equal(
            teng.generate_beam(torch.from_numpy(full), 10,
                               num_beams=2).numpy(), got.numpy())


def test_beam_bounded_reorder_debug_and_storage(monkeypatch):
    """The reorder below the fill bound gives the full-length reorder's
    beams (2-bit, flushes crossing); debug=True (every beam step a
    checked call) the same; a beam step keeps every state tensor's
    storage (what a captured step needs)."""
    _, teng = _engines(2, 4)
    toks = torch.from_numpy(_toks(6, (2, 30)))
    bounded = teng.generate_beam(toks, 40, num_beams=2)
    ptrs = {n: getattr(teng._beams[2, 2], n).data_ptr()
            for n in ("token", "pos", "scores", "alive", "lengths", "out",
                      "step", "parent")}
    teng.generate_beam(toks[:1], 8, num_beams=4)      # another shape
    again = teng.generate_beam(toks, 40, num_beams=2)
    assert {n: getattr(teng._beams[2, 2], n).data_ptr() for n in ptrs} == ptrs
    assert torch.equal(again, bounded)
    full = KC.reorder_into
    monkeypatch.setattr(KC, "reorder_into",
                        lambda c, idx, bound=None: full(c, idx))
    _, ref = _engines(2, 4)
    assert torch.equal(ref.generate_beam(toks, 40, num_beams=2), bounded)
    monkeypatch.undo()
    _, dbg = _engines(2, 4, debug=True)
    assert torch.equal(dbg.generate_beam(toks, 40, num_beams=2), bounded)
    with pytest.raises(ValueError, match="num_beams"):
        teng.generate_beam(toks, 4, num_beams=3)
