"""The decode kernels' static fill bound (t_bound) in the port (CPU: the
plain versions of rows 6 and 9) against the JAX package's, mirroring
tests/test_fused_decode.py:277-318:

  * the plain per-row KIVI decode (row 6) and the plain per-row fp
    decode (row 9) with t_bound equal themselves without it, bit for
    bit, wherever the contract holds (every row's n_k_quant and
    n_v_quant + W, or its length, at most t_bound), and attend only
    positions below t_bound where it does not;
  * `decode_attention(fill_bound=)` over per-row device counters
    against the JAX `decode_attention`: its oracle (impl="jnp") within
    atol = rtol = 1e-5 (tests/test_torch_attention.py's: the same f32
    math summed in another order), and the Pallas wide kernel under the
    same fill_bound (interpret mode) within 3e-2 (the JAX test's);
  * `fp_decode_attention(fill_bound=)` over per-row lengths against the
    JAX Pallas fp kernel under the same fill_bound within 2^-9 max|v| +
    1e-5 (tests/test_torch_fp_cache.py's: the kernel rounds p to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import fp_cache as JFC
from kivi_tpu.cache.kivi_cache import (decode_append, init_layer_cache,
                                       prefill_ingest)
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.core.attention import decode_attention as j_decode
from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core.attention import decode_attention, t_bound_for
from kivi_tpu_torch.kernels import fp_decode as FD
from kivi_tpu_torch.kernels import fused_decode as FR

torch.set_num_threads(2)

WIDE = dict(k_bits=2, v_bits=2, group_size=32, residual_length=128,
            v_flush=128)
TOL = dict(atol=1e-5, rtol=1e-5)


def _mk_cache(T_prompt, steps, B=2, H=4, D=128, Tmax=1024, seed=0):
    """tests/test_fused_decode.py's cache: a JAX prompt ingest and
    `steps` decode appends."""
    qcfg = JQuantConfig(**WIDE)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    cache = init_layer_cache(B, H, D, Tmax, qcfg)
    k = jax.random.normal(ks[0], (B, H, T_prompt, D), jnp.float32)
    v = jax.random.normal(ks[1], (B, H, T_prompt, D), jnp.float32)
    cache = prefill_ingest(cache, k, v, qcfg)
    step = jax.jit(lambda c, kn, vn: decode_append(c, kn, vn, qcfg))
    for i in range(steps):
        kn = jax.random.normal(jax.random.fold_in(ks[2], i), (B, H, 1, D),
                               jnp.float32)
        vn = jax.random.normal(jax.random.fold_in(ks[3], i), (B, H, 1, D),
                               jnp.float32)
        cache = step(cache, kn, vn)
    return cache


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


def _port(jc) -> KC.KiviLayerCache:
    """The JAX cache's bits in the port's layout, counters on the
    device (per row)."""
    c = KC.KiviLayerCache(
        **{n: _t(getattr(jc, n)) for n in (
            "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
            "k_win", "v_win")},
        **{n: int(getattr(jc, n)) for n in KC._COUNTERS})
    KC.counters_to_device([c])
    return c


def _rows_args(c, r, seed):
    B, H = c.k_win.shape[:2]
    q = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, H, r, 128)).astype(np.float32))
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    return (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win, counts)


@pytest.mark.parametrize("tprompt,steps,r,tb", [
    (40, 0, 4, 512),      # all-window, one live split of two
    (200, 60, 4, 512),    # mid-stream, bound tight over fill=260
    (300, 140, 2, 512),   # fill=440, the window near the bound
    (500, 11, 1, 512),    # fill=511, n_v_quant + W exactly the bound
    (200, 60, 4, 1024),   # bound == Tmax: the full grid
])
def test_rows_t_bound_matches_unbounded(tprompt, steps, r, tb):
    c = _port(_mk_cache(tprompt, steps))
    assert (c.n_k_quant <= tb).all() and (c.n_v_quant + 128 <= tb).all()
    args = _rows_args(c, r, tprompt)
    kw = dict(group_size=32, k_bits=2, v_bits=2,
              lo=torch.tensor([0, 17], dtype=torch.int32))
    full = FR.fused_decode_attention_plain(*args, **kw)
    bounded = FR.fused_decode_attention(*args, t_bound=tb, **kw)
    np.testing.assert_array_equal(bounded.numpy(), full.numpy())


def test_rows_t_bound_truncates_past_it():
    """A violated bound: positions at or past t_bound are not attended
    (the kernel's function; the contract is the caller's)."""
    c = _port(_mk_cache(600, 0))
    args = _rows_args(c, 2, 1)
    kw = dict(group_size=32, k_bits=2, v_bits=2)
    got = FR.fused_decode_attention_plain(*args, t_bound=256, **kw)
    # the same attention over a cache cut to its first 256 positions
    counts = torch.tensor([[256, 0, 256]] * 2, dtype=torch.int32)
    want = FR.fused_decode_attention_plain(*args[:-1], counts, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="t_bound"):
        FR.fused_decode_attention_plain(*args, t_bound=300, **kw)


def _fp_caches(lens, H=2, D=128, Tmax=1024, seed=5):
    """JAX fp caches of one length per row (batch-1 each) and the port's
    slot cache holding them row by row."""
    rng = np.random.default_rng(seed)
    tc = FC.init_fp_slot_cache(len(lens), H, D, Tmax, torch.float32, "cpu")
    jcs = []
    for b, n in enumerate(lens):
        kv = rng.standard_normal((2, 1, H, n, D)).astype(np.float32)
        jc = JFC.fp_append(JFC.init_fp_cache(1, H, D, Tmax, jnp.float32),
                           jnp.asarray(kv[0]), jnp.asarray(kv[1]))
        jcs.append(jc)
        one = FC.init_fp_cache(1, H, D, Tmax, torch.float32, "cpu")
        FC.fp_append(one, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]))
        KC.write_slot(tc, b, one)
    return jcs, tc


@pytest.mark.parametrize("lens,tb,sw", [((300, 17), 512, None),
                                        ((511, 512), 512, 100),
                                        ((700, 1), 1024, None),
                                        ((1000, 200), 768, None)])
def test_fp_rows_t_bound(lens, tb, sw):
    """Row 9's per-row entry: bit-equal to the unbounded plain version
    where every length is at most t_bound; past it (the last case's row
    0), the attention of the positions below t_bound, the sliding window
    still counted back from the row's own length."""
    jcs, tc = _fp_caches(lens)
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (len(lens), 2, 2, 128)).astype(np.float32))
    kw = dict(sliding_window=sw)
    full = FD.fp_decode_attention_plain(q, tc.k, tc.v, tc.length, **kw)
    got = FD.fp_decode_attention_kernel(q, tc.k, tc.v, tc.length,
                                        t_bound=tb, **kw)
    for b, n in enumerate(lens):
        if n <= tb:
            np.testing.assert_array_equal(got[b].numpy(), full[b].numpy())
        else:
            cut = FD.fp_decode_attention_plain(
                q[b:b + 1], tc.k[b:b + 1, ..., :tb], tc.v[b:b + 1, :, :tb],
                tb)
            np.testing.assert_allclose(got[b].numpy(), cut[0].numpy(),
                                       **TOL)


@pytest.mark.parametrize("tprompt,steps,fb", [(200, 60, 260),
                                              (300, 140, 440),
                                              (40, 0, 40)])
@pytest.mark.parametrize("r", [2, 4])
def test_decode_attention_fill_bound_matches_jax(tprompt, steps, fb, r):
    jc = _mk_cache(tprompt, steps)
    tc = _port(jc)
    B, H = 2, 4
    q = jax.random.normal(jax.random.PRNGKey(9), (B, H * r, 1, 128),
                          jnp.float32)
    got = decode_attention(torch.from_numpy(np.array(q)), tc,
                           QuantConfig(**WIDE), fill_bound=fb)
    assert t_bound_for(fb, 1024, 128) < 1024    # a real bound
    oracle = j_decode(q, jc, JQuantConfig(**WIDE), impl="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    kern = j_decode(q, jc, JQuantConfig(**WIDE), impl="pallas",
                    fill_bound=fb)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("r", [1, 2])
def test_fp_decode_attention_fill_bound_matches_jax(r):
    lens = (300, 160)
    jcs, tc = _fp_caches(lens)
    q = np.random.default_rng(2).standard_normal(
        (len(lens), 2 * r, 1, 128)).astype(np.float32)
    got = FC.fp_decode_attention(torch.from_numpy(q), tc, fill_bound=300)
    assert t_bound_for(300, 1024) < 1024
    for b, jc in enumerate(jcs):
        want = JFC.fp_decode_attention(jnp.asarray(q[b:b + 1]), jc,
                                       impl="pallas", fill_bound=300)
        vmax = float(np.abs(np.asarray(jc.v)).max())
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   atol=2.0 ** -9 * vmax + 1e-5, rtol=0)
