"""The port's Engine (kivi_tpu_torch.serving.engine, CPU) against the JAX
package's Engine(impl="jnp"): chunked and one-shot prefill, then greedy
decode across K and V window flushes on the static schedule; the
fp16-cache baseline engine, teacher-forced; and the port's sampling
processors against kivi_tpu.serving.sampling on the same logits.

Tolerance: greedy tokens equal.  Both engines run the same f32 weights
over f32 caches (f32 windows and scales), so the two libraries' logits
differ by float32 rounding only and no argmax flips.  The fp16-cache
engine's logits: 2e-2, the JAX package's tolerance for its bf16-rounding
decode oracle (tests/test_kernels.py:170) — JAX's `impl="jnp"` fp
decode rounds the query and the probabilities to bf16, the port's does
not.  Sampling transforms: exactly equal outputs (same f32 operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.serving import sampling as JS
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving import sampling as TS
from kivi_tpu_torch.serving import engine as TE
from kivi_tpu_torch.serving.engine import Engine

torch.set_num_threads(2)

B, TMAX, PROMPT, NEW = 2, 384, 200, 80


def _engines(bits, vf):
    """bits 16: the fp16-cache baseline (QuantConfig(16, 16, ...))."""
    kw = dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=128,
              v_flush=vf, scale_dtype="float32")
    jcfg, tcfg = j_tiny_config(), tiny_config()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                         torch.float32)
    jeng = JEngine(cfg=jcfg, qcfg=JQuantConfig(**kw), params=jp,
                   max_seq_len=TMAX, batch_size=B, impl="jnp")
    jeng.cache_dtype = jnp.float32
    teng = Engine(cfg=tcfg, qcfg=QuantConfig(**kw), params=tp,
                  max_seq_len=TMAX, batch_size=B, device="cpu",
                  cache_dtype=torch.float32)
    return jeng, teng


@pytest.mark.parametrize("bits,vf,pad", [(2, 128, None), (4, 32, None),
                                         (2, 32, (0, 37))])
def test_generate_greedy_matches_jax(bits, vf, pad):
    """pad: rows LEFT-padded by these many slots (masked in every chunk
    and decode step, RoPE positions shifted)."""
    jeng, teng = _engines(bits, vf)
    toks = np.random.default_rng(bits).integers(0, 256, (B, PROMPT))
    want = np.asarray(jeng.generate(jnp.asarray(toks, jnp.int32), NEW,
                                    prefill_chunk_size=128, pad_lens=pad))
    got = teng.generate(torch.from_numpy(toks), NEW, prefill_chunk_size=128,
                        pad_lens=pad)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    # the run crossed K and V flushes: 200 prompt tokens leave 72 in the
    # K window, which fills after 56 steps
    events = TE.flush_schedule(teng.qcfg, PROMPT, NEW - 1)
    assert events == JEngine._flush_schedule(jeng.qcfg, PROMPT, NEW - 1)
    assert any(k for k, _ in events.values())
    assert any(v for _, v in events.values())


@pytest.mark.parametrize("bits,vf,pad", [(2, 128, None), (4, 32, (0, 37))])
def test_generate_oneshot_greedy_matches_jax(bits, vf, pad):
    """generate() without prefill_chunk_size: one-shot prefill (exact
    attention over the whole prompt, then prefill_ingest), then decode
    across K and V flushes."""
    jeng, teng = _engines(bits, vf)
    toks = np.random.default_rng(10 + bits).integers(0, 256, (B, PROMPT))
    want = np.asarray(jeng.generate(jnp.asarray(toks, jnp.int32), NEW,
                                    pad_lens=pad))
    got = teng.generate(torch.from_numpy(toks), NEW, pad_lens=pad)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    # Engine.prefill: the greedy first token of the same one-shot prefill
    first, caches = teng.prefill(torch.from_numpy(toks), pad_lens=pad)
    assert first.dtype == torch.int32 and first.shape == (B, 1)
    np.testing.assert_array_equal(first[:, 0].numpy(), want[:, 0])
    assert caches[0].seq_len == PROMPT


@pytest.mark.parametrize("pad", [None, (0, 37)])
def test_fp16_engine_teacher_forced_matches_jax(pad):
    """The fp16-cache engine: one-shot prefill, then decode fed the JAX
    engine's greedy tokens step by step (so a near tie cannot fork the
    two streams); every step's logits compared."""
    jeng, teng = _engines(16, 32)
    assert not teng.qcfg.quantize_kv
    toks = np.random.default_rng(16).integers(0, 256, (B, PROMPT))
    jtoks = jnp.asarray(toks, jnp.int32)
    stream = np.asarray(jeng.generate(jtoks, NEW // 4, pad_lens=pad))
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    want, jc = jeng._prefill(jeng.params, jtoks, jeng.init_caches(), jpad)
    got, tc = teng._prefill(torch.from_numpy(toks), pad_lens=pad)
    # prefill attention is exact f32 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), stream[:, 0])
    pos = np.full((B, 1), PROMPT) - (0 if pad is None else
                                     np.array(pad)[:, None])
    for i in range(stream.shape[1] - 1):
        tok = stream[:, i:i + 1].copy()
        want, jc = jeng._decode(jeng.params, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos + i, jnp.int32), jc, jpad)
        got, tc = teng.decode_step(torch.from_numpy(tok),
                                   torch.from_numpy(pos + i), tc,
                                   pad_lens=pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-2, rtol=0, err_msg=f"step {i}")
    assert tc[0].length == PROMPT + stream.shape[1] - 1


def test_schedule_helpers_match_jax():
    from kivi_tpu.serving import engine as JE
    for vf in (32, 64, 128):
        kw = dict(group_size=32, residual_length=128, v_flush=vf)
        tq, jq = QuantConfig(**kw), JQuantConfig(**kw)
        assert TE.phase_period(tq) == JE.phase_period(jq)
        for T in (0, 1, 127, 128, 129, 200, 511, 1024, 1500):
            assert TE.canonical_phase(tq, T) == JE.canonical_phase(jq, T)
            assert TE.nkq_prefill(T, 128) == JE.nkq_prefill(T, 128)
            assert TE.nvq_canonical(T, 128, vf) == \
                JE.nvq_canonical(T, 128, vf)
            assert TE.flush_schedule(tq, T, 300) == \
                JEngine._flush_schedule(jq, T, 300)


def test_generate_options_and_unported_paths():
    _, teng = _engines(2, 128)
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, (1, 64)))
    # a batch smaller than batch_size is topped up; EOS pads after
    out = teng.generate(toks, 6, prefill_chunk_size=128)
    assert out.shape == (1, 6)
    eos = int(out[0, 2])
    cut = teng.generate(toks, 6, prefill_chunk_size=128, eos_token_id=eos)
    first = int((out[0] == eos).nonzero()[0])
    assert cut[0, :first + 1].tolist() == out[0, :first + 1].tolist()
    assert (cut[0, first:] == eos).all()
    # one-shot prefill (no prefill_chunk_size) now runs: the same
    # options on it
    one = teng.generate(toks, 6)
    assert one.shape == (1, 6)
    eos = int(one[0, 2])
    cut = teng.generate(toks, 6, eos_token_id=eos)
    first = int((one[0] == eos).nonzero()[0])
    assert cut[0, :first + 1].tolist() == one[0, :first + 1].tolist()
    assert (cut[0, first:] == eos).all()
    # prefix snapshots and ragged suffixes come with a later slice
    with pytest.raises(NotImplementedError):
        teng.generate(toks, 4, prefix=object())
    with pytest.raises(NotImplementedError):
        teng.generate(toks, 4, prefill_chunk_size=128, prefix=object())
    if not torch.cuda.is_available():
        # no card and no device="cpu": raise, never run on the host
        with pytest.raises(RuntimeError):
            Engine(cfg=teng.cfg, qcfg=teng.qcfg, params=teng.params,
                   max_seq_len=TMAX, batch_size=B)


def _logits(seed, shape=(3, 50)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, 7] = x[0, 3]                      # a tie
    return x


@pytest.mark.parametrize("top_k", [0, 1, 5, 50])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_warpers_match_jax(top_k, top_p, temperature):
    x = _logits(top_k + int(10 * top_p))
    want = JS.warp_logits(jnp.asarray(x), temperature=temperature,
                          top_k=top_k, top_p=top_p)
    got = TS.warp_logits(torch.from_numpy(x), temperature=temperature,
                         top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        TS.apply_top_k(torch.from_numpy(x), top_k).numpy(),
        np.asarray(JS.apply_top_k(jnp.asarray(x), top_k)))
    np.testing.assert_array_equal(
        TS.apply_top_p(torch.from_numpy(x), top_p).numpy(),
        np.asarray(JS.apply_top_p(jnp.asarray(x), top_p)))


def test_penalty_seen_and_sample_step_match_jax():
    x = _logits(3)
    toks = np.array([[1, 4, 4, 9], [0, 2, 3, 49], [5, 5, 5, 5]], np.int32)
    pad = np.array([0, 2, 1], np.int32)
    jseen = JS.seen_mask_from_prompt(jnp.asarray(toks), 50,
                                     pad_len=jnp.asarray(pad))
    tseen = TS.seen_mask_from_prompt(torch.from_numpy(toks), 50,
                                     pad_len=torch.from_numpy(pad))
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    new = np.array([7, 0, 49], np.int32)
    jseen = JS.update_seen(jseen, jnp.asarray(new))
    tseen = TS.update_seen(tseen, torch.from_numpy(new))
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    for pen in (1.0, 1.3, 0.8):
        np.testing.assert_array_equal(
            TS.apply_repetition_penalty(torch.from_numpy(x), tseen,
                                        pen).numpy(),
            np.asarray(JS.apply_repetition_penalty(jnp.asarray(x), jseen,
                                                   pen)))
    # greedy, and sampling restricted to one token, are deterministic
    np.testing.assert_array_equal(
        TS.sample_step(torch.from_numpy(x)).numpy(),
        np.asarray(JS.sample_step(jnp.asarray(x), None)))
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        TS.sample_step(torch.from_numpy(x), gen, temperature=0.9,
                       top_k=1).numpy(),
        np.asarray(JS.sample_step(jnp.asarray(x), jax.random.PRNGKey(0),
                                  temperature=0.9, top_k=1)))
    # a sampled draw lands inside the warped support
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        tok = TS.sample_step(torch.from_numpy(x), gen, temperature=1.0,
                             top_k=4, top_p=0.8)
        support = np.isfinite(np.asarray(JS.warp_logits(
            jnp.asarray(x), temperature=1.0, top_k=4, top_p=0.8)))
        assert support[np.arange(3), tok.numpy()].all()


def test_sampled_generate_runs_with_penalty():
    """Sampled decode with temperature, top-k/top-p and the repetition
    penalty: a torch.Generator makes the draw reproducible."""
    _, teng = _engines(2, 128)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (B, 140)))
    kw = dict(prefill_chunk_size=128, temperature=0.8, top_k=20, top_p=0.9,
              repetition_penalty=1.2)
    a = teng.generate(toks, 10, generator=torch.Generator().manual_seed(1),
                      **kw)
    b = teng.generate(toks, 10, generator=torch.Generator().manual_seed(1),
                      **kw)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 256)).all()
