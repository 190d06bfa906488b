"""The port's quantize/pack/dequant (kivi_tpu_torch.core.quant and the
quant_pack wrappers on CPU) against the JAX package's kivi_tpu.core.quant.

Tolerance: codes bit-equal (the port's int32 words compared as uint32),
scale and min exactly equal, dequantized values exactly equal — both
sides run the same f32 operations in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.core import quant as JQ
from kivi_tpu_torch.core import quant as TQ
from kivi_tpu_torch.kernels.quant_pack import quantize_pack_k, quantize_pack_v

torch.set_num_threads(2)


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., :32] = 0.75          # a constant group: scale 0, codes 0
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 64, 96), (1, 2, 128, 32)])
def test_quantize_k_block_matches_jax(bits, dtype, shape):
    gs = 32
    x = _inputs(shape, 0, dtype)                   # (B, H, D, T)
    jc, js, jm = JQ.quantize_k_block(jnp.asarray(x), gs, bits)
    tc, ts, tm = TQ.quantize_k_block(torch.from_numpy(x), gs, bits)
    np.testing.assert_array_equal(_u32(tc), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        TQ.dequantize_k(tc, ts, tm, gs, bits).numpy(),
        np.asarray(JQ.dequantize_k(jc, js, jm, gs, bits)))
    # the kernel wrapper on a CPU tensor takes the natural layout
    wc, ws, wm = quantize_pack_k(torch.from_numpy(x).transpose(-1, -2),
                                 gs, bits)
    np.testing.assert_array_equal(_u32(wc.contiguous()), np.asarray(jc))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(js))
    np.testing.assert_array_equal(wm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 96, 64), (1, 2, 32, 128)])
def test_quantize_v_block_matches_jax(bits, dtype, shape):
    gs = 32
    x = _inputs(shape, 1, dtype)                   # (B, H, T, D)
    jc, js, jm = JQ.quantize_v_block(jnp.asarray(x), gs, bits)
    tc, ts, tm = TQ.quantize_v_block(torch.from_numpy(x), gs, bits)
    np.testing.assert_array_equal(_u32(tc.contiguous()), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        TQ.dequantize_v(tc, ts, tm, gs, bits).numpy(),
        np.asarray(JQ.dequantize_v(jc, js, jm, gs, bits)))
    wc, ws, wm = quantize_pack_v(torch.from_numpy(x), gs, bits)
    np.testing.assert_array_equal(_u32(wc.contiguous()), np.asarray(jc))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", [-1, -2, 1])
def test_pack_unpack_matches_jax(bits, axis):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 1 << bits, size=(2, 64, 32, 64),
                         dtype=np.int64).astype(np.uint32)
    for jpack, junpack, tpack, tunpack, ok in [
            (JQ.pack_planar, JQ.unpack_planar, TQ.pack_planar,
             TQ.unpack_planar, True),
            (JQ.pack_crumbs, JQ.unpack_crumbs, TQ.pack_crumbs,
             TQ.unpack_crumbs, bits in (2, 4)),
            (JQ.pack_codes, JQ.unpack_codes, TQ.pack_codes,
             TQ.unpack_codes, True)]:
        if not ok:
            continue
        jw = np.asarray(jpack(jnp.asarray(codes), bits, axis))
        tw = tpack(torch.from_numpy(codes.astype(np.int32)), bits, axis)
        assert tw.dtype == torch.int32
        np.testing.assert_array_equal(_u32(tw.contiguous()), jw)
        back = tunpack(tw, bits, axis)
        np.testing.assert_array_equal(back.numpy(), codes.astype(np.int32))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(junpack(jnp.asarray(jw), bits, axis)))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_last_and_helpers(bits):
    x = _inputs((3, 5, 128), 3, "float32")
    jc, js, jm = JQ.quantize_last(jnp.asarray(x), 32, bits)
    tc, ts, tm = TQ.quantize_last(torch.from_numpy(x), 32, bits)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        TQ.dequantize_last(tc, ts, tm, 32).numpy(),
        np.asarray(JQ.dequantize_last(jc, js, jm, 32)))
    assert TQ.num_words(128, bits) == JQ.num_words(128, bits)
    if bits < 8:
        assert TQ.crumb_factor(bits) == JQ.crumb_factor(bits)
