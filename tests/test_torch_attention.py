"""The port's decode_attention / extend_attention / prefill_attention
(CPU: the plain versions beside the CUDA kernels) against the JAX
package's impl="jnp" functions on identical cache states and inputs.

The cache is built by the JAX package and copied into the port's
layout (uint32 words reinterpreted as int32), so both sides read the
same bits.  Tolerance: atol = rtol = 1e-5 in f32 — the same math, summed
in a different order by two libraries.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.core.attention import decode_attention as j_decode
from kivi_tpu.core.attention import extend_attention as j_extend
from kivi_tpu.core.attention import prefill_attention as j_prefill
from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core.attention import (decode_attention,
                                           extend_attention,
                                           prefill_attention)

torch.set_num_threads(2)

B, H, D, TMAX = 2, 2, 64, 512
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_port(jc) -> KiviLayerCache:
    f = {n: _t(getattr(jc, n)) for n in (
        "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
        "k_win", "v_win")}
    return KiviLayerCache(**f, n_k_quant=int(jc.n_k_quant),
                          n_k_win=int(jc.n_k_win),
                          n_v_quant=int(jc.n_v_quant),
                          n_v_win=int(jc.n_v_win))


def _cfgs(bits, vf):
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=32,
              residual_length=128, v_flush=vf)
    return QuantConfig(**kw), JQuantConfig(**kw)


@functools.lru_cache(maxsize=None)
def _cache(jq, prompt, steps, seed):
    """JAX cache after a prompt and decode steps (memoized: the cases
    share their cache states across mask variants)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    cache = JC.init_layer_cache(B, H, D, TMAX, jq)
    cache = JC.prefill_ingest(cache, n(B, H, prompt, D), n(B, H, prompt, D),
                              jq)
    step = jax.jit(lambda c, k, v: JC.decode_append(c, k, v, jq))
    for _ in range(steps):
        cache = step(cache, n(B, H, 1, D), n(B, H, 1, D))
    return cache


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CASES = [  # bits, v_flush, prompt, decode steps, r
    ((2, 2), 128, 40, 0, 2),     # nothing quantized yet
    ((2, 2), 128, 200, 60, 1),   # MHA, both stores live
    ((4, 4), 32, 200, 60, 2),    # n_v_quant < n_k_quant
    ((8, 8), 32, 190, 140, 2),   # several K and V flushes
    ((2, 8), 128, 256, 0, 1),    # K window empty
    ((8, 2), 32, 300, 7, 2),
]


@pytest.mark.parametrize("bits,vf,prompt,steps,r", CASES)
@pytest.mark.parametrize("masks", ["none", "pad", "swa", "pad+swa"])
def test_decode_attention_matches_jax(bits, vf, prompt, steps, r, masks):
    tq, jq = _cfgs(bits, vf)
    jc = _cache(jq, prompt, steps, seed=prompt + steps)
    tc = to_port(jc)
    q = _np((B, H * r, 1, D), 5)
    kw_j, kw_t = {}, {}
    if "pad" in masks:
        pad = np.array([0, 37], np.int32)
        kw_j["pad_len"], kw_t["pad_len"] = jnp.asarray(pad), torch.tensor(pad)
    if "swa" in masks:
        kw_j["sliding_window"] = kw_t["sliding_window"] = 96
    want = j_decode(jnp.asarray(q), jc, jq, impl="jnp", **kw_j)
    got = decode_attention(torch.from_numpy(q), tc, tq, **kw_t)
    assert got.dtype == torch.float32 and got.shape == (B, H * r, 1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits,vf,prompt,steps,r", CASES)
@pytest.mark.parametrize("masks", ["none", "pad", "swa"])
def test_extend_attention_matches_jax(bits, vf, prompt, steps, r, masks):
    tq, jq = _cfgs(bits, vf)
    jc = _cache(jq, prompt, steps, seed=prompt + steps)
    tc = to_port(jc)
    T1 = 48
    q = _np((B, H * r, T1, D), 6)
    k_new, v_new = _np((B, H, T1, D), 7), _np((B, H, T1, D), 8)
    kw_j, kw_t = {}, {}
    if masks == "pad":
        pad = np.array([0, 150], np.int32)
        kw_j["pad_len"], kw_t["pad_len"] = jnp.asarray(pad), torch.tensor(pad)
    if masks == "swa":
        kw_j["sliding_window"] = kw_t["sliding_window"] = 100
    want = j_extend(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                    jc, jq, impl="jnp", **kw_j)
    got = extend_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                           torch.from_numpy(v_new), tc, tq, **kw_t)
    assert got.shape == (B, H * r, T1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("r", [1, 2])
def test_extend_fully_padded_first_chunk(r):
    """Chunk 0 of a row padded past the chunk's end: every history and
    self position but the diagonal is masked, and the output stays
    finite (no NaN) and equal to the JAX oracle."""
    tq, jq = _cfgs((2, 2), 128)
    jc = JC.init_layer_cache(B, H, D, TMAX, jq)
    tc = to_port(jc)
    T1 = 64
    q = _np((B, H * r, T1, D), 9)
    k_new, v_new = _np((B, H, T1, D), 10), _np((B, H, T1, D), 11)
    pad = np.array([3, 100], np.int32)
    want = j_extend(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                    jc, jq, impl="jnp", pad_len=jnp.asarray(pad))
    got = extend_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                           torch.from_numpy(v_new), tc, tq,
                           pad_len=torch.tensor(pad))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [64, 100])          # 100: not a tile multiple
@pytest.mark.parametrize("r", [1, 2])             # MHA, GQA r = 2
@pytest.mark.parametrize("masks", ["none", "swa", "pad", "pad+swa"])
def test_prefill_attention_matches_jax(T, r, masks):
    """Exact causal prefill attention; with a left pad, the fully padded
    query rows come out exactly 0 (not a uniform average)."""
    q = _np((B, H * r, T, D), 12)
    k, v = _np((B, H, T, D), 13), _np((B, H, T, D), 14)
    kw_j, kw_t = {}, {}
    pad = np.array([0, 37], np.int32)
    if "pad" in masks:
        kw_j["pad_len"], kw_t["pad_len"] = jnp.asarray(pad), torch.tensor(pad)
    if "swa" in masks:
        kw_j["sliding_window"] = kw_t["sliding_window"] = 24
    want = j_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     impl="jnp", **kw_j)
    got = prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw_t)
    assert got.dtype == torch.float32 and got.shape == (B, H * r, T, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if "pad" in masks:
        assert (got[1, :, :pad[1]] == 0).all()
        assert (got[1, :, pad[1]:].abs().amax(-1) > 0).all()
