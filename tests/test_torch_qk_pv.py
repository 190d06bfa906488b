"""The port's split decode kernels (`kivi_tpu_torch.kernels.qk_pv`, CPU:
the plain versions) against the JAX package's Pallas kernels
`qk_dequant_matmul` / `pv_dequant_matmul` in interpret mode, and the
port's split decode route (`core.attention._decode_attention_split`)
against the JAX package's decode attention.

Inputs are made from a seed with numpy and quantized by the JAX package;
the port reads the same bits (uint32 words as int32).

Tolerances:
  * plain versions vs the Pallas kernels at compute_dtype=float32:
    rtol 2e-5, atol 2e-4 (tests/test_kernels.py: the same math in f32,
    summed in another order);
  * the split route vs `decode_attention(impl="jnp")`: 1e-5, the port's
    attention tolerance (tests/test_torch_attention.py);
  * the split route vs `decode_attention(impl="pallas")` at W = 32,
    where the JAX package itself takes the split kernels in bf16:
    max|diff| < 3e-2 max|ref| (tests/test_kernels.py:37).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.core import quant as JQ
from kivi_tpu.core.attention import decode_attention as j_decode
from kivi_tpu.kernels import pv_dequant_matmul as j_pv
from kivi_tpu.kernels import qk_dequant_matmul as j_qk
from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import attention as TA
from kivi_tpu_torch.kernels.qk_pv import (NEG_INF, pv_dequant_matmul,
                                          pv_dequant_matmul_plain,
                                          qk_dequant_matmul,
                                          qk_dequant_matmul_plain)

torch.set_num_threads(2)

B, H, D, T, GS = 1, 2, 64, 1024, 32
KTOL = dict(rtol=2e-5, atol=2e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# n_quant: nothing, a partial tile (300 of the JAX kernel's 512), all
NQ = [0, 300, T]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("nq", NQ)
def test_qk_plain_matches_pallas(bits, r, nq):
    k_t = _np((B, H, D, T), bits)
    q = _np((B, H, r, D), 10 + r)
    codes, scale, mn = JQ.quantize_k_block(jnp.asarray(k_t), GS, bits)
    want = np.asarray(j_qk(jnp.asarray(q), codes, scale, mn, GS, bits,
                           n_quant=nq, compute_dtype=jnp.float32))
    args = (torch.from_numpy(q), _t(codes), _t(scale), _t(mn), GS, bits)
    got = qk_dequant_matmul_plain(*args, n_quant=nq)
    assert got.dtype == torch.float32 and got.shape == (B, H, r, T)
    np.testing.assert_allclose(got.numpy(), want, **KTOL)
    # positions at or past n_quant are the mask value, in both
    assert (got[..., nq:] == NEG_INF).all()
    assert (want[..., nq:] == NEG_INF).all()
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(qk_dequant_matmul(*args, n_quant=nq), got)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("nq", NQ)
def test_pv_plain_matches_pallas(bits, r, nq):
    """p is a softmax over the first nq positions and exactly zero past
    them (the zero-probability tail the decode route relies on)."""
    v = _np((B, H, T, D), 20 + bits)
    logits = _np((B, H, r, T), 30 + r)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p[..., nq:] = 0.0
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    codes, scale, mn = JQ.quantize_v_block(jnp.asarray(v), GS, bits)
    want = np.asarray(j_pv(jnp.asarray(p), codes, scale, mn, GS, bits,
                           n_quant=nq, compute_dtype=jnp.float32))
    args = (torch.from_numpy(p), _t(codes), _t(scale), _t(mn), GS, bits)
    got = pv_dequant_matmul_plain(*args, n_quant=nq)
    assert got.dtype == torch.float32 and got.shape == (B, H, r, D)
    np.testing.assert_allclose(got.numpy(), want, **KTOL)
    if nq == 0:
        assert (got == 0).all()
    assert torch.equal(pv_dequant_matmul(*args, n_quant=nq), got)


def test_pv_default_n_quant_is_all_positions():
    v = _np((B, H, T, D), 3)
    p = _np((B, H, 2, T), 4)
    codes, scale, mn = JQ.quantize_v_block(jnp.asarray(v), GS, 4)
    args = (torch.from_numpy(p), _t(codes), _t(scale), _t(mn), GS, 4)
    np.testing.assert_array_equal(pv_dequant_matmul_plain(*args).numpy(),
                                  pv_dequant_matmul_plain(*args, n_quant=T))


# ---------------------------------------------------------------------------
# the split decode route
# ---------------------------------------------------------------------------

TMAX = 512


def to_port(jc) -> KiviLayerCache:
    f = {n: _t(getattr(jc, n)) for n in (
        "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
        "k_win", "v_win")}
    return KiviLayerCache(**f, n_k_quant=int(jc.n_k_quant),
                          n_k_win=int(jc.n_k_win),
                          n_v_quant=int(jc.n_v_quant),
                          n_v_win=int(jc.n_v_win))


def _cfgs(bits, W, vf):
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=32,
              residual_length=W, v_flush=vf)
    return QuantConfig(**kw), JQuantConfig(**kw)


@functools.lru_cache(maxsize=None)
def _cache(jq, prompt, steps, seed, batch=2):
    """JAX cache after a prompt and decode steps (memoized)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    cache = JC.init_layer_cache(batch, H, D, TMAX, jq)
    cache = JC.prefill_ingest(cache, n(batch, H, prompt, D),
                              n(batch, H, prompt, D), jq)
    step = jax.jit(lambda c, k, v: JC.decode_append(c, k, v, jq))
    for _ in range(steps):
        cache = step(cache, n(batch, H, 1, D), n(batch, H, 1, D))
    return cache


@pytest.fixture
def split_spy(monkeypatch):
    """Send every host-int call to the split route and count the kernel
    wrappers it calls."""
    monkeypatch.setattr(TA, "SPLIT_MIN_HISTORY", 0)
    calls = {"qk": 0, "pv": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TA, "qk_dequant_matmul",
                        spy("qk", TA.qk_dequant_matmul))
    monkeypatch.setattr(TA, "pv_dequant_matmul",
                        spy("pv", TA.pv_dequant_matmul))
    return calls


CASES = [  # bits, W, v_flush, prompt, decode steps, r
    ((2, 2), 32, 32, 20, 0, 2),      # nothing quantized yet
    ((2, 2), 32, 32, 200, 45, 4),    # the slice's geometry: W = 32
    ((4, 4), 128, 32, 200, 60, 2),   # n_v_quant < n_k_quant
    ((8, 8), 32, 32, 190, 70, 1),    # several K and V flushes
    ((2, 4), 128, 128, 256, 0, 4),   # K window empty
]


@pytest.mark.parametrize("bits,W,vf,prompt,steps,r", CASES)
@pytest.mark.parametrize("masks", ["none", "pad", "swa"])
def test_split_decode_matches_jax_oracle(split_spy, bits, W, vf, prompt,
                                         steps, r, masks):
    tq, jq = _cfgs(bits, W, vf)
    jc = _cache(jq, prompt, steps, seed=prompt + steps)
    tc = to_port(jc)
    q = _np((2, H * r, 1, D), 5)
    kw_j, kw_t = {}, {}
    if masks == "pad":
        # below every row's length: a row padded past its last token has
        # no defined output (see _decode_attention_split)
        pad = np.array([0, 13], np.int32)
        kw_j["pad_len"], kw_t["pad_len"] = jnp.asarray(pad), torch.tensor(pad)
    if masks == "swa":
        kw_j["sliding_window"] = kw_t["sliding_window"] = 96
    want = j_decode(jnp.asarray(q), jc, jq, impl="jnp", **kw_j)
    got = TA.decode_attention(torch.from_numpy(q), tc, tq, **kw_t)
    assert split_spy == {"qk": 1, "pv": 1}
    assert got.dtype == torch.float32 and got.shape == (2, H * r, 1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", [(2, 2), (4, 4), (2, 4)])
@pytest.mark.parametrize("pad", [None, (0, 37)])
def test_split_decode_matches_jax_pallas_route(split_spy, bits, pad):
    """At W = 32 the JAX package's own dispatch takes its split kernels
    (bf16 compute): the port's route agrees within their tolerance."""
    tq, jq = _cfgs(bits, 32, 32)
    jc = _cache(jq, 230, 20, seed=sum(bits))
    tc = to_port(jc)
    q = _np((2, H * 4, 1, D), 6)
    kw_j, kw_t = {}, {}
    if pad is not None:
        kw_j["pad_len"] = jnp.asarray(pad, jnp.int32)
        kw_t["pad_len"] = torch.tensor(pad)
    want = np.asarray(j_decode(jnp.asarray(q), jc, jq, impl="pallas",
                               **kw_j))
    got = TA.decode_attention(torch.from_numpy(q), tc, tq, **kw_t).numpy()
    assert split_spy == {"qk": 1, "pv": 1}
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 3e-2, rel


def test_split_decode_equals_fused_plain():
    """On the same host-int cache, the split route and the fused route
    (the wide kernel's plain version) compute one function."""
    tq, jq = _cfgs((2, 2), 32, 32)
    tc = to_port(_cache(jq, 300, 9, seed=4))
    q = torch.from_numpy(_np((2, H, 4, D), 7))
    lo = torch.tensor([0, 50], dtype=torch.int32)
    got = TA._decode_attention_split(q, tc, tq, lo)
    from kivi_tpu_torch.kernels.fused_decode_wide import \
        fused_decode_attention_wide_plain
    want = fused_decode_attention_wide_plain(
        q, tc.k_codes, tc.k_scale, tc.k_mn, tc.v_codes, tc.v_scale, tc.v_mn,
        tc.k_win, tc.v_win, tc.n_k_quant, tc.n_k_win, tc.n_v_quant,
        group_size=32, k_bits=2, v_bits=2, lo=lo)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
