"""Fake quantization (simulate mode): port of `kivi_tpu/core/fake_quant.py`.

The reference's quantizer library (`SymQuantizer` / `AsymQuantizer` /
grouped by-channel variants with straight-through gradients, its
`models/utils_quant.py`) as quantize-dequantize in one step: no packing,
no cache, so any tensor path can be degraded to b bits and its effect
measured, with straight-through estimators so that the transforms stay
differentiable under autograd.

Plain torch on any device, in the input's dtype, as the JAX module is
plain jnp; there is no kernel behind it.  Quotients divide by tensors,
never by Python numbers: on CUDA torch turns division by a scalar into a
reciprocal multiply, which is not the IEEE quotient (core/quant.py).
"""

from __future__ import annotations

import torch


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward q, the gradient of the identity in x."""
    return x + (q - x).detach()


def _reduce(fn, x: torch.Tensor, axis):
    return fn(x) if axis is None else fn(x, dim=axis, keepdim=True)


def fake_quant_sym(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Symmetric: scale by max |x| (per axis when given), round to the
    signed b-bit grid (the reference's SymQuantizer)."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = _reduce(torch.amax, x.abs(), axis)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax), 1.0)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
    return _ste(x, q)


def fake_quant_asym(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Asymmetric min/max (the reference's AsymQuantizer)."""
    levels = float(2 ** bits - 1)
    mn = _reduce(torch.amin, x, axis)
    mx = _reduce(torch.amax, x, axis)
    scale = torch.where(mx > mn, (mx - mn) / torch.full_like(mx, levels),
                        1.0)
    q = torch.clamp(torch.round((x - mn) / scale), 0, levels) * scale + mn
    return _ste(x, q)


def fake_quant_grouped(x: torch.Tensor, bits: int, group_size: int,
                       axis: int = -1) -> torch.Tensor:
    """Grouped asymmetric along `axis`: the KIVI cache quantization as a
    one-shot transform (the reference's AsymGroupedQuantizer; the
    core.quant round trip)."""
    axis = axis % x.ndim
    x_m = torch.movedim(x, axis, -1)
    L = x_m.shape[-1]
    assert L % group_size == 0, (L, group_size)
    g = x_m.reshape(*x_m.shape[:-1], L // group_size, group_size)
    q = fake_quant_asym(g, bits, axis=-1).reshape(x_m.shape)
    return torch.movedim(q, -1, axis)


def fake_quant_kv(k: torch.Tensor, v: torch.Tensor, k_bits: int,
                  v_bits: int, group_size: int):
    """KIVI's axes as a simulate-mode pair: K per channel (groups along
    tokens, axis -2), V per token (groups along channels, axis -1).
    k, v: (..., T, D)."""
    kq = fake_quant_grouped(k, k_bits, group_size, axis=-2)
    vq = fake_quant_grouped(v, v_bits, group_size, axis=-1)
    return kq, vq
