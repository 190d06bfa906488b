"""The quantizers' in-place entries and plain versions against the JAX
package, on the CPU:

  * `quantize_pack_k_into_plain` / `quantize_pack_v_into_plain` (what the
    in-place CUDA entry is held to on the card) against the JAX cache's
    writes: `jax.vmap` of `flush_k_masked` / `flush_v_masked` over
    batch-1 caches for per-row device offsets with a predicate, and
    `_append_k_quant` / `_append_v_quant` for one host-int offset;
  * the plain `quantize_pack_k` / `quantize_pack_v` against the JAX
    Pallas kernels in interpret mode;
  * the in-place entry's argument checks.

Tolerances: the in-place writes bit for bit on every store (codes as
uint32, f32 and bf16 stats and the rows left out exactly): both sides
run the same f32 operations (the JAX side eager, see
tests/test_torch_cache.py) and cast to bf16 by round-to-nearest-even.
Against Pallas, as tests/test_kernels.py holds Pallas to the jnp
reference: scale and min within 1e-6 relative; a code may flip at a
rounding tie (Pallas multiplies by a reciprocal where the plain version
divides), so > 99.9% of codes equal and every dequantized value within
one scale step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.core import quant as JQ
from kivi_tpu.kernels import quant_pack as JP
from kivi_tpu_torch.core import quant as TQ
from kivi_tpu_torch.kernels import quant_pack as QP

torch.set_num_threads(2)

S, H, D, W, TMAX, GS = 4, 2, 64, 64, 256, 32
FIELDS = ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
          "k_win", "v_win")
SDT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_values(rng, shape):
    """Normal f32 values that bf16 holds exactly."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _stores(rng, rows, bits, sdt):
    """Numpy stores of `rows` rows filled with random bytes and values (a
    write that lands where it should not shows), bf16 windows."""
    kdw, vdw = D * bits[0] // 32, D * bits[1] // 32
    u32 = lambda *s: rng.integers(0, 2 ** 32, size=s, dtype=np.uint32)
    st = lambda *s: _bf16_values(rng, s)      # exact in f32 and bf16
    return {"k_codes": u32(rows, H, kdw, TMAX),
            "k_scale": st(rows, H, TMAX // GS, D),
            "k_mn": st(rows, H, TMAX // GS, D),
            "v_codes": u32(rows, H, vdw, TMAX),
            "v_scale": st(rows, H, D // GS, TMAX),
            "v_mn": st(rows, H, D // GS, TMAX),
            "k_win": _bf16_values(rng, (rows, H, W, D)),
            "v_win": _bf16_values(rng, (rows, H, W, D))}


def _jax_field(name, a, sdt):
    if name.endswith("codes"):
        return jnp.asarray(a)
    if name.endswith("win"):
        return jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(a, SDT[sdt][0])


def _torch_field(name, a, sdt):
    if name.endswith("codes"):
        return torch.from_numpy(a.view(np.int32).copy())
    if name.endswith("win"):
        return torch.from_numpy(a.copy()).to(torch.bfloat16)
    return torch.from_numpy(a.copy()).to(SDT[sdt][1])


def _assert_store_equal(t, j, what):
    j = np.asarray(j)
    if t.dtype == torch.int32:
        np.testing.assert_array_equal(t.numpy().view(np.uint32), j,
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32), err_msg=what)


def _kind_args(kind, cache, vf):
    """(block, stores) of one kind in a port cache dict."""
    if kind == "k":
        return cache["k_win"], (cache["k_codes"], cache["k_scale"],
                                cache["k_mn"])
    return cache["v_win"][:, :, :vf], (cache["v_codes"], cache["v_scale"],
                                       cache["v_mn"])


# rows: (n_quant, n_win, pred): a flushing row; an inactive row at
# n_win == W (left out, its stores untouched); a full store (n_quant ==
# Tmax: the write clamps to the last slice); a row whose window is not
# full (left out)
ROWS = ((64, W, True), (128, W, False), (TMAX, W, True), (96, W - 3, True))


@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kind", ["k", "v"])
def test_into_plain_matches_jax_masked_flush(kind, bits, sdt):
    """Per-row device offsets and a predicate: the plain in-place write of
    each row's window against jax.vmap of the JAX cache's masked flush,
    bit for bit on every store, at bf16 and f32 stats stores."""
    vf = 32
    kw = dict(k_bits=bits, v_bits=bits, group_size=GS, residual_length=W,
              v_flush=vf, scale_dtype=sdt)
    jq = JQuantConfig(**kw)
    rng = np.random.default_rng(bits * 7 + len(sdt) + (kind == "v"))
    arrays = _stores(rng, S, (bits, bits), sdt)
    nq = np.array([r[0] for r in ROWS], np.int32)
    nw = np.array([r[1] for r in ROWS], np.int32)
    pred = np.array([r[2] for r in ROWS])
    counters = {"n_k_quant": nq, "n_k_win": nw, "n_v_quant": nq,
                "n_v_win": nw}
    jstack = JC.KiviLayerCache(
        **{f: _jax_field(f, a[:, None], sdt) for f, a in arrays.items()},
        **{c: jnp.asarray(a) for c, a in counters.items()})
    jflush = JC.flush_k_masked if kind == "k" else JC.flush_v_masked
    with jax.disable_jit():
        jout = jax.vmap(lambda c, p: jflush(c, jq, pred=p))(
            jstack, jnp.asarray(pred))

    port = {f: _torch_field(f, a, sdt) for f, a in arrays.items()}
    sel = torch.from_numpy(pred) & (torch.from_numpy(nw) == W)
    block, stores = _kind_args(kind, port, vf)
    into = (QP.quantize_pack_k_into_plain if kind == "k"
            else QP.quantize_pack_v_into_plain)
    into(block, GS, bits, *stores, torch.from_numpy(nq), sel)
    for f in FIELDS[:6]:
        _assert_store_equal(port[f], getattr(jout, f)[:, 0],
                            f"{kind} bits={bits} {sdt} {f}")
    # the rows left out kept every byte; the clamped row wrote
    for f, t in port.items():
        if f.startswith(kind) and not f.endswith("win"):
            ref = _torch_field(f, arrays[f], sdt)
            assert torch.equal(t[1], ref[1]) and torch.equal(t[3], ref[3])
            assert not torch.equal(t[2], ref[2])


@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["k", "v"])
def test_into_plain_host_offset_matches_jax_append(kind, sdt):
    """One host-int offset (prefill ingest, extend, the engine's flushes):
    the plain in-place write of a 96-token block against the JAX cache's
    _append_k_quant / _append_v_quant, bit for bit."""
    bits, n, off = (2, 4), 96, 64
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=GS,
              residual_length=W, v_flush=32, scale_dtype=sdt)
    jq = JQuantConfig(**kw)
    rng = np.random.default_rng(11 + (kind == "v"))
    arrays = _stores(rng, 2, bits, sdt)
    x = _bf16_values(rng, (2, H, n, D))
    jc = JC.KiviLayerCache(
        **{f: _jax_field(f, a, sdt) for f, a in arrays.items()},
        **{c: jnp.int32(off) for c in ("n_k_quant", "n_v_quant")},
        **{c: jnp.int32(0) for c in ("n_k_win", "n_v_win")})
    jappend = JC._append_k_quant if kind == "k" else JC._append_v_quant
    with jax.disable_jit():
        jout = jappend(jc, jnp.asarray(x, jnp.bfloat16), jq, n)
    port = {f: _torch_field(f, a, sdt) for f, a in arrays.items()}
    stores = [port[f"{kind}_{s}"] for s in ("codes", "scale", "mn")]
    into = (QP.quantize_pack_k_into_plain if kind == "k"
            else QP.quantize_pack_v_into_plain)
    into(torch.from_numpy(x).to(torch.bfloat16), GS, bits[kind == "v"],
         *stores, off)
    for f in FIELDS[:6]:
        _assert_store_equal(port[f], getattr(jout, f), f"{kind} {sdt} {f}")


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kind", ["k", "v"])
def test_plain_quantizer_matches_pallas(kind, bits, T):
    """The port's plain quantize_pack_k/v against the JAX Pallas kernels
    in interpret mode (which take the transposed (B, H, D, T) block), on
    f32 data as tests/test_kernels.py (bf16 data, with 8 mantissa bits,
    lands on exact rounding ties far more often)."""
    rng = np.random.default_rng(bits + T)
    x = rng.standard_normal((1, H, T, D)).astype(np.float32)
    x[0, 0, :GS, :GS] = 0.5                      # a constant group
    xt = jnp.swapaxes(jnp.asarray(x), -1, -2)
    if kind == "k":
        jc, js, jm = JP.quantize_pack_k(xt, GS, bits)
        tc, ts, tm = QP.quantize_pack_k(torch.from_numpy(x), GS, bits)
        deq = lambda c, s, m: np.asarray(JQ.dequantize_k(c, s, m, GS, bits))
    else:
        jc, js, jm = JP.quantize_pack_v(xt, GS, bits)
        tc, ts, tm = QP.quantize_pack_v(torch.from_numpy(x), GS, bits)
        deq = lambda c, s, m: np.asarray(JQ.dequantize_v(c, s, m, GS, bits))
    step = np.repeat(np.swapaxes(np.asarray(js), -1, -2), GS, axis=-1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    t_codes = TQ.unpack_codes(tc, bits, axis=-2).numpy()
    j_codes = np.asarray(JQ.unpack_codes(jc, bits, axis=-2))
    assert (t_codes == j_codes).mean() > 0.999
    d_t = deq(jnp.asarray(tc.numpy().view(np.uint32)), js, jm)
    d_j = deq(jc, js, jm)
    assert np.all(np.abs(d_t - d_j) <= step + 1e-6)


def _into_case(bits=2, is_key=True, B=2, T=64, tmax=128, sdt=torch.float32):
    x = torch.zeros(B, H, T, D, dtype=torch.bfloat16)
    dw = D * bits // 32
    sshape = (B, H, tmax // GS, D) if is_key else (B, H, D // GS, tmax)
    return dict(x=x, group_size=GS, bits=bits,
                codes=torch.zeros(B, H, dw, tmax, dtype=torch.int32),
                scale=torch.zeros(sshape, dtype=sdt),
                mn=torch.zeros(sshape, dtype=sdt),
                off=torch.zeros(B, dtype=torch.int32),
                pred=torch.ones(B, dtype=torch.bool), is_key=is_key)


BAD = {
    "float16 stats": (dict(sdt=torch.float16), {}, TypeError),
    "stats of two dtypes": ({}, dict(mn=torch.zeros(2, H, 4, D,
                                                    dtype=torch.bfloat16)),
                            ValueError),
    "codes too short": ({}, dict(codes=torch.zeros(2, H, 4, 32,
                                                   dtype=torch.int32)),
                        ValueError),
    "int64 offsets": ({}, dict(off=torch.zeros(2, dtype=torch.int64)),
                      ValueError),
    "offsets of another batch": ({}, dict(off=torch.zeros(3,
                                                          dtype=torch.int32)),
                                 ValueError),
    "predicate not bool": ({}, dict(pred=torch.ones(2, dtype=torch.int32)),
                           ValueError),
    "predicate with a host offset": ({}, dict(off=0), TypeError),
    "host offset past the store": ({}, dict(off=96, pred=None), ValueError),
    "non-contiguous store": ({}, dict(scale=torch.zeros(
        2, H, D, 4).transpose(-1, -2)), ValueError),
    "f32 input": ({}, dict(x=torch.zeros(2, H, 64, D)), TypeError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_check_into_args_refuses(case):
    """The in-place entry's wrapper refuses what its kernel does not take
    (it runs these checks before every CUDA launch)."""
    build, over, err = BAD[case]
    args = {**_into_case(**build), **over}
    with pytest.raises(err):
        QP.check_into_args(**args)


@pytest.mark.parametrize("is_key", [True, False])
@pytest.mark.parametrize("host", [True, False])
def test_check_into_args_accepts(is_key, host):
    args = _into_case(is_key=is_key, sdt=torch.bfloat16)
    if host:
        args.update(off=64, pred=None)
    QP.check_into_args(**args)
