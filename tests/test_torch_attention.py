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


# ---------------------------------------------------------------------------
# per-row counters: the continuous batcher's slot caches (row 6 of the
# kernel table, `fused_decode_attention`)
# ---------------------------------------------------------------------------

# (prompt, decode steps) per slot: an empty slot, a window-only one, K
# ahead of V (n_k_quant > n_v_quant with v_flush 32), several flushes
SLOTS = [(0, 0), (40, 0), (200, 60), (190, 140)]


@functools.lru_cache(maxsize=None)
def _slot_caches(jq, seed):
    """One batch-1 JAX cache per slot (memoized), at divergent fills."""
    rng = np.random.default_rng(seed)
    n = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    step = jax.jit(lambda c, k, v: JC.decode_append(c, k, v, jq))
    out = []
    for prompt, steps in SLOTS:
        c = JC.init_layer_cache(1, H, D, TMAX, jq)
        if prompt:
            c = JC.prefill_ingest(c, n(1, H, prompt, D), n(1, H, prompt, D),
                                  jq)
        for _ in range(steps):
            c = step(c, n(1, H, 1, D), n(1, H, 1, D))
        out.append(c)
    return out


def to_slot_port(jcs) -> KiviLayerCache:
    """Batch-1 JAX caches -> one port slot cache: rows stacked, counters
    (S,) int32 tensors."""
    ones = [to_port(c) for c in jcs]
    f = {n: torch.cat([getattr(c, n) for c in ones]) for n in (
        "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
        "k_win", "v_win")}
    cnt = {n: torch.tensor([getattr(c, n) for c in ones], dtype=torch.int32)
           for n in ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win")}
    return KiviLayerCache(**f, **cnt)


@pytest.mark.parametrize("bits,vf", [((2, 2), 128), ((4, 4), 32),
                                     ((8, 8), 32), ((2, 8), 32)])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("masks", ["none", "pad", "swa"])
def test_decode_attention_per_row_matches_vmapped_jax(bits, vf, r, masks):
    """A slot cache (per-row device counters) through decode_attention,
    which routes it to fused_decode_attention's plain version, against
    jax.vmap over slots of the JAX oracle on batch-1 caches."""
    tq, jq = _cfgs(bits, vf)
    jcs = _slot_caches(jq, seed=sum(bits) + vf)
    tc = to_slot_port(jcs)
    assert isinstance(tc.seq_len, torch.Tensor)
    S = len(jcs)
    q = _np((S, H * r, 1, D), 15)
    pad = np.array([0, 3, 37, 100], np.int32)
    sw = 96 if masks == "swa" else None
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jcs)

    def one(q1, c1, p1):
        return j_decode(q1[None], c1, jq, impl="jnp", sliding_window=sw,
                        pad_len=p1[None] if masks == "pad" else None)[0]

    want = jax.vmap(one)(jnp.asarray(q), jstack, jnp.asarray(pad))
    got = decode_attention(torch.from_numpy(q), tc, tq, sliding_window=sw,
                           pad_len=torch.tensor(pad) if masks == "pad"
                           else None)
    assert got.dtype == torch.float32 and got.shape == (S, H * r, 1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the empty slot (seq_len 0) returns exact zeros
    assert int(tc.seq_len[0]) == 0 and (got[0] == 0).all()
    if vf < 128:      # some slot holds K/V watermarks that differ
        assert (tc.n_k_quant > tc.n_v_quant).any()


@pytest.mark.parametrize("bits", [(2, 2), (4, 4), (2, 4)])
def test_fused_decode_per_row_matches_pallas_kernel(bits):
    """The plain version of row 6 against the JAX package's
    fused_decode_attention in interpret mode, run per slot, within the
    tolerance tests/test_fused_decode.py holds that kernel to against
    the split oracle (3e-2: the Pallas body computes in bf16)."""
    from kivi_tpu.kernels.fused_decode import \
        fused_decode_attention as j_fused

    from kivi_tpu_torch.kernels.fused_decode import \
        fused_decode_attention_plain
    tq, jq = _cfgs(bits, 32)
    jcs = _slot_caches(jq, seed=7)
    tc = to_slot_port(jcs)
    S, r = len(jcs), 2
    qg = _np((S, H, r, D), 16)
    pad = np.array([0, 5, 37, 64], np.int32)
    counts = torch.stack([tc.n_k_quant, tc.n_k_win, tc.n_v_quant], dim=1)
    got = fused_decode_attention_plain(
        torch.from_numpy(qg), tc.k_codes, tc.k_scale, tc.k_mn, tc.v_codes,
        tc.v_scale, tc.v_mn, tc.k_win, tc.v_win, counts, group_size=32,
        k_bits=bits[0], v_bits=bits[1], lo=torch.tensor(pad))
    for s, c in enumerate(jcs):
        want = j_fused(jnp.asarray(qg[s:s + 1]), c.k_codes, c.k_scale,
                       c.k_mn, c.v_codes, c.v_scale, c.v_mn, c.k_win,
                       c.v_win, c.n_k_quant, c.n_k_win, c.n_v_quant,
                       group_size=32, k_bits=bits[0], v_bits=bits[1],
                       pad_len=jnp.asarray(pad[s:s + 1]))
        np.testing.assert_allclose(got[s:s + 1].numpy(), np.asarray(want),
                                   rtol=3e-2, atol=3e-2, err_msg=f"slot {s}")
    assert (got[0] == 0).all()


def test_fused_decode_per_row_uniform_equals_wide():
    """At counters equal on every row, the per-row plain version is the
    wide (host-int) one."""
    from kivi_tpu_torch.kernels.fused_decode import \
        fused_decode_attention_plain
    from kivi_tpu_torch.kernels.fused_decode_wide import \
        fused_decode_attention_wide_plain
    tq, jq = _cfgs((2, 4), 32)
    tc = to_port(_cache(jq, 200, 60, seed=260))
    qg = torch.from_numpy(_np((B, H, 2, D), 17))
    arrays = (qg, tc.k_codes, tc.k_scale, tc.k_mn, tc.v_codes, tc.v_scale,
              tc.v_mn, tc.k_win, tc.v_win)
    kw = dict(group_size=32, k_bits=2, v_bits=4, lo=torch.tensor([0, 37]))
    counts = torch.tensor([[tc.n_k_quant, tc.n_k_win, tc.n_v_quant]] * B)
    got = fused_decode_attention_plain(*arrays, counts, **kw)
    want = fused_decode_attention_wide_plain(
        *arrays, tc.n_k_quant, tc.n_k_win, tc.n_v_quant, **kw)
    assert torch.equal(got, want)
