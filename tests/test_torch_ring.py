"""The port's ring attention and sequence-parallel prefill
(kivi_tpu_torch.parallel.ring, Engine.prefill_seqpar) over gloo worlds
of 2 and 4 CPU processes, against the JAX package's ring on as many
virtual devices (kivi_tpu.parallel.ring.ring_attention; the cases of
tests/test_ring.py:54-168) and its Engine.prefill_seqpar.

Tolerances: f32 inputs within 2e-5 (the JAX ring's own bound against
one-device attention: both rings fold blocks in the same order, i, i-1,
..., and differ by f32 rounding); bf16 inputs within one bf16 ulp of
the output (2^-8 relative: both rings compute in f32 from the same bf16
inputs and round their outputs to bf16); left-padded rows compared on
their real positions only (a pad query's output is garbage by
convention in both).  The engine: logits and a teacher-forced decode
step within 2e-4 at f32 weights and caches, every layer's packed K/V
words >= 99.9% equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.parallel.ring import ring_attention as j_ring
from kivi_tpu.parallel.ring import zigzag_perm as j_zigzag
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.parallel.ring import ring_attention, zigzag_perm
from kivi_tpu_torch.serving.engine import Engine
from torch_dist import flat_params, spawn

torch.set_num_threads(2)

# name: (B, Hq, Hkv, D, seed, bf16, zigzag, window, score_chunk, pad)
CASES = {
    "r1": (2, 2, 2, 16, 0, False, False, 0, 0, None),
    "r4": (2, 8, 2, 16, 0, False, False, 0, 0, None),
    "window": (1, 4, 4, 16, 1, False, False, 24, 0, None),
    "pad": (3, 2, 2, 16, 2, False, False, 0, 0, (0, 5, 17)),
    "bf16": (2, 4, 2, 32, 3, True, False, 0, 0, None),
    "chunk1": (2, 4, 2, 16, 7, False, False, 0, 1, None),
    "chunk3": (2, 4, 2, 16, 7, False, False, 0, 3, None),
    "chunk4_window_pad": (2, 4, 2, 16, 7, False, False, 24, 4, (0, 6)),
    "zigzag": (2, 4, 2, 16, 5, False, True, 0, 0, None),
    "zigzag_window_pad": (2, 4, 4, 16, 6, False, True, 20, 0, (0, 9)),
    "zigzag_chunk2": (1, 2, 2, 16, 8, False, True, 0, 2, None),
}
T = 64


def _case_inputs(name):
    B, Hq, Hkv, D, seed, bf16, *_ = CASES[name]
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D))]
    if bf16:   # values a bf16 holds exactly, so both sides read the same
        x = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in x]
    return x


def _jax_ring(name, n):
    """The JAX ring on n virtual devices, in true token order."""
    _, _, _, _, _, bf16, zig, window, chunk, pad = CASES[name]
    q, k, v = (jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
               for a in _case_inputs(name))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    kw = dict(sliding_window=window or None, score_chunk=chunk or None,
              pad_len=None if pad is None else jnp.asarray(pad, jnp.int32))
    if not zig:
        return np.asarray(j_ring(q, k, v, mesh, **kw), np.float32)
    perm, inv = j_zigzag(T, n)
    got = j_ring(q[:, :, perm], k[:, :, perm], v[:, :, perm], mesh,
                 positions=perm, **kw)
    return np.asarray(got, np.float32)[:, :, inv]


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Each world's outputs per case, reassembled in true token order."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    inputs = {"cases": np.array(list(CASES))}
    for name, (_, _, _, _, _, bf16, zig, window, chunk, pad) in CASES.items():
        for x, a in zip("qkv", _case_inputs(name)):
            inputs[f"{name}.{x}"] = a
        inputs[f"{name}.bf16"] = np.array(bf16)
        inputs[f"{name}.zigzag"] = np.array(zig)
        inputs[f"{name}.window"] = np.array(window)
        inputs[f"{name}.chunk"] = np.array(chunk)
        if pad is not None:
            inputs[f"{name}.pad"] = np.array(pad, np.int64)
    runs = {}
    for n in (2, 4):
        outs = spawn("ring", n, tmp_path_factory.mktemp(f"ring{n}"), inputs)
        for name, c in CASES.items():
            full = np.zeros((c[0], c[1], T, c[3]), np.float32)
            for o in outs:
                full[:, :, o[f"{name}.slots"]] = o[name]
            runs[n, name] = full
    return runs


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring(ring_runs, n, name):
    got, want = ring_runs[n, name], _jax_ring(name, n)
    bf16, pad = CASES[name][5], CASES[name][9]
    tol = (dict(rtol=2.0 ** -8, atol=2.0 ** -8) if bf16
           else dict(rtol=2e-5, atol=2e-5))
    for b in range(got.shape[0]):
        p = 0 if pad is None else pad[b]
        np.testing.assert_allclose(got[b, :, p:], want[b, :, p:], **tol,
                                   err_msg=f"{name} n={n} row {b}")


def test_ring_of_one_and_zigzag_perm_match_jax():
    """group=None is a ring of one: the whole block, no send (held to the
    JAX ring on one device); zigzag_perm equals the JAX package's."""
    q, k, v = _case_inputs("chunk4_window_pad")
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         sliding_window=24, score_chunk=4,
                         pad_len=torch.tensor([0, 6]))
    want = _jax_ring("chunk4_window_pad", 1)
    for b, p in enumerate((0, 6)):
        np.testing.assert_allclose(got.numpy()[b, :, p:], want[b, :, p:],
                                   rtol=2e-5, atol=2e-5)
    for T_, n in ((96, 4), (64, 8), (12032, 1)):
        for a, b in zip(zigzag_perm(T_, n), j_zigzag(T_, n)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divisible"):
        zigzag_perm(60, 8)


# ---------------------------------------------------------------------------
# Engine.prefill_seqpar at n = 2
# ---------------------------------------------------------------------------

SEQ = {"contig": (False, None, 2), "striped": (True, None, 2),
       "padded": (True, (0, 11), 8)}


def _jparams():
    return JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                          dtype=jnp.float32)


def _jeng(bits):
    e = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(
        bits, bits, 32, 32, scale_dtype="float32"), params=_jparams(),
        max_seq_len=256, batch_size=2, impl="jnp")
    e.cache_dtype = jnp.float32
    return e


@pytest.fixture(scope="module")
def seqpar_run(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    toks = np.random.default_rng(1).integers(1, 256, (2, 64))
    inputs = {"tokens": toks, "pads": np.array((0, 11), np.int64),
              **flat_params(jax.tree_util.tree_map(np.asarray, _jparams()))}
    # the teacher-forced decode token: the port's one-shot argmax
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, _jparams()),
                         "cpu", torch.float32)
    for name, (_, pads, bits) in SEQ.items():
        eng = Engine(tiny_config(), QuantConfig(bits, bits, 32, 32,
                                                scale_dtype="float32"),
                     tp, 256, 2, device="cpu", cache_dtype=torch.float32)
        lg, _ = eng._prefill(torch.from_numpy(toks), pad_lens=pads)
        inputs[f"{name}.next"] = lg.argmax(-1, keepdim=True).numpy()
    out = spawn("seqpar", 2, tmp_path_factory.mktemp("seqpar"), inputs)
    return toks, inputs, out


@pytest.mark.parametrize("name", list(SEQ))
def test_engine_seqpar_matches_jax(seqpar_run, name):
    """Both ranks' logits, K/V codes and decode step against the JAX
    Engine.prefill_seqpar on a 2-device mesh."""
    toks, inputs, out = seqpar_run
    striped, pads, bits = SEQ[name]
    e = _jeng(bits)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    lg, caches = e.prefill_seqpar(jnp.asarray(toks, jnp.int32), mesh,
                                  pad_lens=pads, striped=striped)
    pad = None if pads is None else jnp.asarray(pads, jnp.int32)
    pos = jnp.full((2, 1), 64, jnp.int32)
    if pad is not None:
        pos = pos - pad[:, None]
    codes = {f: np.stack([np.asarray(getattr(c, f)) for c in caches])
             for f in ("k_codes", "v_codes")}
    dec, _ = e._decode(e.params, jnp.asarray(inputs[f"{name}.next"],
                                             jnp.int32), pos, caches, pad)
    for o in out:
        np.testing.assert_allclose(o[f"{name}.logits"], np.asarray(lg),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(o[f"{name}.decode"], np.asarray(dec),
                                   rtol=2e-4, atol=2e-4)
        for f, want in codes.items():
            same = (o[f"{name}.{f}"].view(np.uint32)
                    == want.view(np.uint32)).reshape(len(want), -1)
            assert same.mean(1).min() >= 0.999, (name, f, same.mean(1))
    np.testing.assert_array_equal(out[0][f"{name}.logits"],
                                  out[1][f"{name}.logits"])


def test_seqpar_prefix_and_indivisible_length(seqpar_run):
    """prefill_prefix(seq_mesh=) gives the one-shot snapshot's codes
    (>= 99.9% of words), and a prompt of 63 tokens over 2 ranks is
    refused before any collective."""
    for o in seqpar_run[2]:
        assert float(o["prefix_equal"]) >= 0.999
        assert "not divisible" in str(o["indivisible"])
