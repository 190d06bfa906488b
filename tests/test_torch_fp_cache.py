"""The port's fp16-cache baseline (kivi_tpu_torch.cache.fp_cache and the
plain version of kernels/fp_decode.py, CPU) against the JAX package's
kivi_tpu.cache.fp_cache and kivi_tpu.kernels.fp_decode.

Tolerances:
  * cache fields: equal (the same values copied into the same layout);
  * fp_extend_attention: atol = rtol = 1e-5 in f32 (the same einsums,
    summed in a different order by two libraries);
  * fp_decode_attention against the Pallas kernel (interpret mode on the
    CPU, as tests/test_kernels.py runs it): the kernel rounds the
    probabilities to bf16 before PV (relative error <= 2**-9) and the
    port keeps them in f32, so the outputs differ by at most
    2**-9 * max|v| (a convex combination of v with weights off by that
    factor), plus 1e-5 for summation order;
  * against the JAX jnp oracle, which also rounds the query and (over a
    bf16 cache) the logits and the output to bf16: the JAX package's
    own kernel-vs-oracle tolerance, 2e-2 (tests/test_kernels.py:170).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import fp_cache as JF
from kivi_tpu.kernels.fp_decode import fp_decode_attention_kernel as j_kern
from kivi_tpu_torch.cache import fp_cache as TF

torch.set_num_threads(2)

B, H, D, TMAX = 2, 2, 64, 256
TOL = dict(atol=1e-5, rtol=1e-5)
_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    if dtype == "bfloat16":     # values both libraries hold exactly
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _both_caches(prompt, steps, dtype, heads=H, d=D, tmax=TMAX, seed=0):
    """The same prompt and decode appends through both packages."""
    tdt, jdt = _DT[dtype]
    tc = TF.init_fp_cache(B, heads, d, tmax, tdt, device="cpu")
    jc = JF.init_fp_cache(B, heads, d, tmax, jdt)
    for i, n in enumerate([prompt] + [1] * steps):
        k = _np((B, heads, n, d), seed + 2 * i, dtype)
        v = _np((B, heads, n, d), seed + 2 * i + 1, dtype)
        TF.fp_append(tc, torch.from_numpy(k), torch.from_numpy(v))
        jc = JF.fp_append(jc, jnp.asarray(k), jnp.asarray(v))
    return tc, jc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_append_match_jax(dtype):
    tc, jc = _both_caches(100, 7, dtype)
    assert tc.length == tc.seq_len == int(jc.length) == 107
    assert tc.max_seq_len == jc.max_seq_len == TMAX
    assert tc.k.shape == (B, H, D, TMAX) and tc.v.shape == (B, H, TMAX, D)
    assert tc.k.dtype == _DT[dtype][0]
    np.testing.assert_array_equal(tc.k.float().numpy(), _f32(jc.k))
    np.testing.assert_array_equal(tc.v.float().numpy(), _f32(jc.v))


def test_init_fp_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TF.init_fp_cache(B, H, D, TMAX).k.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TF.init_fp_cache(B, H, D, TMAX)


@pytest.mark.parametrize("prompt", [0, 90])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("masks", ["none", "pad", "swa", "pad+swa"])
def test_fp_extend_attention_matches_jax(prompt, r, masks):
    """With a pad past the history (row 1 padded by 120 > 90), the
    causal diagonal keeps the fully padded rows finite."""
    tc, jc = _both_caches(prompt, 0, "float32", seed=prompt)
    T1 = 40
    q = _np((B, H * r, T1, D), 20)
    kn, vn = _np((B, H, T1, D), 21), _np((B, H, T1, D), 22)
    kw_j, kw_t = {}, {}
    if "pad" in masks:
        pad = np.array([0, 120], np.int32)
        kw_j["pad_len"], kw_t["pad_len"] = jnp.asarray(pad), torch.tensor(pad)
    if "swa" in masks:
        kw_j["sliding_window"] = kw_t["sliding_window"] = 50
    want = JF.fp_extend_attention(jnp.asarray(q), jnp.asarray(kn),
                                  jnp.asarray(vn), jc, **kw_j)
    got = TF.fp_extend_attention(torch.from_numpy(q), torch.from_numpy(kn),
                                 torch.from_numpy(vn), tc, **kw_t)
    assert got.dtype == torch.float32 and got.shape == (B, H * r, T1, D)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("masks", ["none", "pad", "swa", "pad+swa"])
def test_fp_decode_attention_matches_pallas_kernel(r, masks):
    """Port (plain version) against the Pallas kernel in interpret mode
    and against the jnp oracle, on a bf16 cache with a bf16 query."""
    heads, d = 4, 128
    tc, jc = _both_caches(150, 3, "bfloat16", heads=heads, d=d)
    q = _np((B, heads * r, 1, d), 30, "bfloat16")
    kw_j, kw_t = {}, {}
    if "pad" in masks:
        pad = np.array([0, 37], np.int32)
        kw_j["pad_len"], kw_t["pad_len"] = jnp.asarray(pad), torch.tensor(pad)
    if "swa" in masks:
        kw_j["sliding_window"] = kw_t["sliding_window"] = 48
    got = TF.fp_decode_attention(torch.from_numpy(q), tc, **kw_t)
    assert got.dtype == torch.float32 and got.shape == (B, heads * r, 1, d)

    qg = jnp.asarray(q).reshape(B, heads, r, d).astype(jnp.bfloat16)
    kern = j_kern(qg, jc.k, jc.v, jc.length, **kw_j)
    vmax = float(np.abs(_f32(jc.v)).max())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(kern).reshape(got.shape),
                               atol=2.0 ** -9 * vmax + 1e-5, rtol=0)

    oracle = JF.fp_decode_attention(jnp.asarray(q), jc, impl="jnp", **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-2,
                               atol=2e-2)


def test_fp_decode_plain_masks_by_row():
    """The plain version's lower bound per row: a row padded to the last
    position attends that position alone, i.e. returns its V row."""
    tc, _ = _both_caches(60, 0, "float32")
    q = torch.from_numpy(_np((B, H, 1, D), 40))
    pad = torch.tensor([0, 59])
    got = TF.fp_decode_attention(q, tc, pad_len=pad)
    np.testing.assert_allclose(got[1, :, 0].numpy(),
                               tc.v[1, :, 59].numpy(), **TOL)
    # a window of 1 does the same for every row
    got = TF.fp_decode_attention(q, tc, sliding_window=1)
    np.testing.assert_allclose(got[:, :, 0].numpy(),
                               tc.v[:, :, 59].numpy(), **TOL)


# ---------------------------------------------------------------------------
# slot caches: per-row lengths (the continuous batcher)
# ---------------------------------------------------------------------------

def test_fp_append_masked_matches_vmapped_jax():
    """fp_append_masked against jax.vmap(fp_cache.fp_append_masked) over
    batch-1 caches, equal after every step: inactive rows write at their
    frozen length, and a full row (length == Tmax) writes at the clamped
    last position, as XLA's dynamic_update_slice does."""
    S = 3
    tc = TF.init_fp_slot_cache(S, H, D, TMAX, torch.float32, device="cpu")
    assert tc.length.dtype == torch.int32 and tc.length.shape == (S,)
    start = np.array([5, 0, TMAX], np.int32)
    tc.length.copy_(torch.from_numpy(start))
    jc = JF.FpLayerCache(k=jnp.zeros((S, 1, H, D, TMAX), jnp.float32),
                         v=jnp.zeros((S, 1, H, TMAX, D), jnp.float32),
                         length=jnp.asarray(start))
    jstep = jax.vmap(lambda c, k, v, a: JF.fp_append_masked(c, k, v, a))
    for i in range(12):
        k = _np((S, 1, H, 1, D), 50 + 2 * i)
        v = _np((S, 1, H, 1, D), 51 + 2 * i)
        act = np.array([i % 3 != 0, True, i % 2 == 0])
        TF.fp_append_masked(tc, torch.from_numpy(k[:, 0]),
                            torch.from_numpy(v[:, 0]), torch.from_numpy(act))
        jc = jstep(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(act))
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k)[:, 0])
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v)[:, 0])


@pytest.mark.parametrize("masks", ["none", "pad", "swa"])
def test_fp_decode_per_row_lengths(masks):
    """fp_decode_attention over a slot cache: each row at its own length
    (0 for an empty slot, which returns zeros), the window counted back
    from the row's own length.  Within 1e-5 of the host-int plain version
    run row by row (the same sums over a longer, zero-padded range), and
    within the JAX package's oracle tolerance (2e-2) of
    jax.vmap over batch-1 caches of its jnp oracle."""
    heads, d, S = 2, 64, 4
    lens = np.array([0, 1, 90, 200], np.int32)
    k = _np((S, heads, d, TMAX), 60, "bfloat16")
    v = _np((S, heads, TMAX, d), 61, "bfloat16")
    tc = TF.FpLayerCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                         length=torch.from_numpy(lens))
    q = _np((S, heads * 2, 1, d), 62, "bfloat16")
    pad = np.array([0, 0, 37, 3], np.int32)
    kw_t, kw_j = {}, {}
    if masks == "pad":
        kw_t["pad_len"], kw_j["pad_len"] = torch.tensor(pad), None
    if masks == "swa":
        kw_t["sliding_window"] = kw_j["sliding_window"] = 48
    got = TF.fp_decode_attention(torch.from_numpy(q), tc, **kw_t)
    assert got.shape == (S, heads * 2, 1, d)
    assert (got[0] == 0).all()
    for s in range(1, S):
        row = TF.FpLayerCache(k=tc.k[s:s + 1], v=tc.v[s:s + 1],
                              length=int(lens[s]))
        kw = dict(kw_t)
        if masks == "pad":
            kw["pad_len"] = kw_t["pad_len"][s:s + 1]
        want = TF.fp_decode_attention(torch.from_numpy(q[s:s + 1]), row, **kw)
        np.testing.assert_allclose(got[s:s + 1].numpy(), want.numpy(),
                                   err_msg=f"row {s}", **TOL)

    jc = JF.FpLayerCache(k=jnp.asarray(k)[:, None], v=jnp.asarray(v)[:, None],
                         length=jnp.asarray(lens))

    def one(q1, c1, p1):
        return JF.fp_decode_attention(
            q1[None], c1, impl="jnp",
            pad_len=p1[None] if masks == "pad" else None,
            sliding_window=kw_j.get("sliding_window"))[0]

    want = jax.vmap(one)(jnp.asarray(q), jc, jnp.asarray(pad))
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(want)[1:],
                               rtol=2e-2, atol=2e-2)
