"""The port's fake quantization (kivi_tpu_torch.core.fake_quant) against
kivi_tpu.core.fake_quant: forward values and straight-through gradients.

The JAX side runs under jax.disable_jit(): jitted, XLA rewrites the
quotients into reciprocal multiplies and the grid can move by a code
(ROADMAP Queue 3, the jitted quantizer).  Eager, both sides divide in
IEEE arithmetic op for op, in the input's dtype.

Tolerance: none against JAX (values and gradients bit-equal, in f32 and
bf16); 1e-5 against the KIVI round trip, as the JAX package holds it.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kivi_tpu.core import fake_quant as JF
from kivi_tpu_torch.core import fake_quant as TF
from kivi_tpu_torch.core import quant as Q

BITS = (2, 4, 8)
DTYPES = ("float32", "bfloat16")


def _x(seed, shape, dtype, kind="normal"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "outliers":
        x[..., 3] *= 30.0
    elif kind == "constant":
        x = np.full(shape, 0.75, np.float32)
    elif kind == "zeros":
        x = np.zeros(shape, np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _equal(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# (name, torch fn, jax fn) over x of shape (2, 3, 64, 32)
CASES = [
    ("sym", lambda m, x, b: m.fake_quant_sym(x, b)),
    ("sym_axis-1", lambda m, x, b: m.fake_quant_sym(x, b, axis=-1)),
    ("sym_axis-2", lambda m, x, b: m.fake_quant_sym(x, b, axis=-2)),
    ("asym", lambda m, x, b: m.fake_quant_asym(x, b)),
    ("asym_axis-1", lambda m, x, b: m.fake_quant_asym(x, b, axis=-1)),
    ("asym_axis-2", lambda m, x, b: m.fake_quant_asym(x, b, axis=-2)),
    ("grouped_axis-1", lambda m, x, b: m.fake_quant_grouped(x, b, 16)),
    ("grouped_axis-2",
     lambda m, x, b: m.fake_quant_grouped(x, b, 32, axis=-2)),
    ("grouped_axis1",
     lambda m, x, b: m.fake_quant_grouped(x, b, 3, axis=1)),
]


@pytest.mark.parametrize("kind", ["normal", "outliers", "constant", "zeros"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(name, fn, dtype, kind):
    x = _x(1, (2, 3, 64, 32), dtype, kind)
    for bits in BITS:
        with jax.disable_jit():
            want = fn(JF, jnp.asarray(x), bits)
        _equal(fn(TF, _torch(x), bits), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_kv_matches_jax(bits, dtype):
    k = _x(2, (1, 2, 64, 128), dtype, "outliers")
    v = _x(3, (1, 2, 64, 128), dtype)
    with jax.disable_jit():
        jk, jv = JF.fake_quant_kv(jnp.asarray(k), jnp.asarray(v), bits,
                                  bits, 32)
    tk, tv = TF.fake_quant_kv(_torch(k), _torch(v), bits, bits, 32)
    _equal(tk, jk)
    _equal(tv, jv)


@pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
def test_gradient_matches_jax(name, fn):
    """d/dx sum(fq(x)^2) through the straight-through estimator: 2 fq(x),
    equal to jax.grad's."""
    x = _x(4, (2, 3, 64, 32), "float32", "outliers")
    for bits in BITS:
        with jax.disable_jit():
            jg = jax.grad(lambda a: jnp.sum(fn(JF, a, bits) ** 2))(
                jnp.asarray(x))
            jq = fn(JF, jnp.asarray(x), bits)
        xt = _torch(x).requires_grad_(True)
        q = fn(TF, xt, bits)
        (q ** 2).sum().backward()
        _equal(xt.grad, jg)
        np.testing.assert_array_equal(xt.grad.numpy(), 2 * _np(q))
        _equal(2 * q, 2 * jq)


@pytest.mark.parametrize("bits", (2, 4))
def test_fake_quant_kv_equals_the_kivi_round_trip(bits):
    """f32: K through core.quant's per-channel store and V through its
    per-token store, quantized and dequantized, equal fake_quant_kv
    within 1e-5, the tolerance of tests/test_quant_core.py:134 in the
    JAX package (here they differ by at most a final ulp)."""
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.standard_normal((2, 4, 64, 128),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 4, 64, 128),
                                             dtype=np.float32))
    fk, fv = TF.fake_quant_kv(k, v, bits, bits, 32)
    rk = Q.dequantize_k(*Q.quantize_k_block(k.transpose(-1, -2), 32, bits),
                        32, bits).transpose(-1, -2)
    rv = Q.dequantize_v(*Q.quantize_v_block(v, 32, bits), 32, bits)
    torch.testing.assert_close(fk, rk, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fv, rv, rtol=1e-5, atol=1e-5)
