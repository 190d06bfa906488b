"""Canonical KIVI quantization semantics and the packed word layout, in
PyTorch.  Port of `kivi_tpu/core/quant.py`; every function here is the
plain version the CUDA quantizer (`kernels/csrc/quant_pack.cu`) is held
to bit for bit.

Semantics (reference `quant/new_pack.py:8-48`):

  * asymmetric, group-wise:  scale = (max - min) / (2**bits - 1),  zp = min
  * codes = clamp(round((x - min) / scale), 0, 2**bits - 1), round half
    to even (`torch.round`, like `jnp.round`)
  * keys are quantized PER-CHANNEL (statistics over a group of tokens),
    values PER-TOKEN (statistics over a group of channels).

Packed words are stored as `torch.int32`, not `uint32`: torch on the CPU
cannot right-shift `uint32`.  The bits are those of the JAX package's
`uint32` words; unpacking is `(w >> s) & mask`, where the mask drops the
sign-extended bits of the arithmetic shift.  Compare with the JAX stores
through `.view(np.uint32)`.

Layouts (identical to the JAX package):

  * crumb packing (2/4-bit): with Dw = D*bits//32 words, channel
    d = j*(2*Dw) + 2*w + h lives in word w, bits [16*h + bits*j, +bits);
  * plane packing (8-bit): channel d = j*Dw + w lives in word w, bits
    [8*j, 8*j + 8);
  * k_codes (B, H, Dw, T), k_scale/k_mn (B, H, T//gs, D);
    v_codes (B, H, Dw, T), v_scale/v_mn (B, H, D//gs, T).
"""

from __future__ import annotations

import torch


def planes_per_word(bits: int) -> int:
    assert bits in (2, 4, 8)
    return 32 // bits


def num_words(head_dim: int, bits: int) -> int:
    fpi = planes_per_word(bits)
    assert head_dim % fpi == 0, (head_dim, bits)
    return head_dim // fpi


def crumb_factor(bits: int) -> int:
    """The JAX package's bitcast-dequant factor F (x = F*scale*b + (mn -
    F*scale), b the bf16 read of a crumb).  Kept for parity; the port
    dequantizes as code*scale + mn in f32 registers."""
    return {2: 128, 4: 16}[bits]


# ---------------------------------------------------------------------------
# Group quantization along the last axis (shared by K and V paths).
# ---------------------------------------------------------------------------

def quantize_last(x: torch.Tensor, group_size: int, bits: int):
    """Asymmetric group quantization along the last axis.

    Returns (codes int32 same shape as x, scale f32 (..., L//gs),
    mn f32 (..., L//gs)).  Op order and the zero-scale guard are those
    of `kivi_tpu/core/quant.py:56-77`, so the codes are bit-equal."""
    L = x.shape[-1]
    assert L % group_size == 0, (L, group_size)
    G = L // group_size
    max_int = (1 << bits) - 1
    xg = x.reshape(*x.shape[:-1], G, group_size).float()
    mn = xg.amin(dim=-1)
    mx = xg.amax(dim=-1)
    # divide by a tensor, not a Python number: on CUDA torch turns
    # division by a scalar into a reciprocal multiply, which is not the
    # IEEE quotient the kernel and the JAX reference compute
    scale = (mx - mn) / torch.full_like(mx, max_int)
    # constant groups: codes become 0 and dequant returns mn exactly
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round((xg - mn[..., None]) / safe[..., None]),
                        0, max_int).to(torch.int32)
    return codes.reshape(x.shape), scale, mn


def dequantize_last(codes: torch.Tensor, scale: torch.Tensor,
                    mn: torch.Tensor, group_size: int) -> torch.Tensor:
    """Inverse of quantize_last (f32 out)."""
    L = codes.shape[-1]
    G = L // group_size
    cg = codes.reshape(*codes.shape[:-1], G, group_size).float()
    out = cg * scale[..., None].float() + mn[..., None].float()
    return out.reshape(codes.shape)


# ---------------------------------------------------------------------------
# Packing.  Words are summed in int64 (disjoint bit fields: sum == OR) and
# wrapped to int32 explicitly, so no shift ever overflows a signed type.
# ---------------------------------------------------------------------------

def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


def pack_planar(codes: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Plane-pack `codes` (values < 2**bits) along `axis`: element
    d = j*Dw + w goes to word w bits [j*bits, (j+1)*bits)."""
    fpi = planes_per_word(bits)
    axis = axis % codes.ndim
    D = codes.shape[axis]
    assert D % fpi == 0
    Dw = D // fpi
    c = codes.movedim(axis, -1).to(torch.int64)
    c = c.reshape(*c.shape[:-1], fpi, Dw)            # plane index j major
    shifts = (torch.arange(fpi, device=c.device) * bits)[:, None]
    words = (c << shifts).sum(dim=-2)
    return _to_int32_bits(words).movedim(-1, axis)


def unpack_planar(words: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Inverse of pack_planar; returns int32 codes."""
    fpi = planes_per_word(bits)
    axis = axis % words.ndim
    mask = (1 << bits) - 1
    w = words.movedim(axis, -1).to(torch.int32)
    shifts = (torch.arange(fpi, device=w.device, dtype=torch.int32)
              * bits)[:, None]
    planes = (w[..., None, :] >> shifts) & mask          # (..., fpi, Dw)
    codes = planes.reshape(*w.shape[:-1], -1)
    return codes.movedim(-1, axis)


def pack_crumbs(codes: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Crumb-pack codes (< 2**bits) along `axis` (bits 2 or 4)."""
    assert bits in (2, 4)
    fpi = 32 // bits
    nj = 16 // bits
    axis = axis % codes.ndim
    D = codes.shape[axis]
    assert D % fpi == 0
    Dw = D // fpi
    c = codes.movedim(axis, -2).to(torch.int64)
    lead, T = c.shape[:-2], c.shape[-1]
    c = c.reshape(*lead, nj, Dw, 2, T)                  # d = j*(2Dw) + 2w + h
    j = torch.arange(nj, device=c.device)[:, None, None, None]
    h = torch.arange(2, device=c.device)[None, None, :, None]
    words = (c << (16 * h + bits * j)).sum(dim=(-4, -2))
    return _to_int32_bits(words).movedim(-2, axis)


def unpack_crumbs(words: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Inverse of pack_crumbs; returns int32 codes."""
    assert bits in (2, 4)
    nj = 16 // bits
    mask = (1 << bits) - 1
    axis = axis % words.ndim
    w = words.movedim(axis, -2).to(torch.int32)
    lead, Dw, T = w.shape[:-2], w.shape[-2], w.shape[-1]
    j = torch.arange(nj, device=w.device, dtype=torch.int32)[:, None, None,
                                                              None]
    h = torch.arange(2, device=w.device, dtype=torch.int32)[None, None, :,
                                                             None]
    c = (w[..., None, :, None, :] >> (16 * h + bits * j)) & mask
    c = c.reshape(*lead, nj * Dw * 2, T)
    return c.movedim(-2, axis)


def pack_codes(codes: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Canonical storage layout: crumbs for 2/4-bit, planes for 8-bit."""
    if bits in (2, 4):
        return pack_crumbs(codes, bits, axis)
    return pack_planar(codes, bits, axis)


def unpack_codes(words: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    if bits in (2, 4):
        return unpack_crumbs(words, bits, axis)
    return unpack_planar(words, bits, axis)


# ---------------------------------------------------------------------------
# K / V block quantizers (the plain versions of kernels/quant_pack.py).
# ---------------------------------------------------------------------------

def quantize_k_block(k_t: torch.Tensor, group_size: int, bits: int):
    """Quantize a transposed key block k_t (B, H, D, T), T % gs == 0.

    Returns k_codes (B, H, Dw, T) int32 and k_scale/k_mn (B, H, T//gs, D)
    f32: one (D,) row per token group."""
    codes, scale, mn = quantize_last(k_t, group_size, bits)  # (B,H,D,Tg)
    words = pack_codes(codes, bits, axis=-2)
    return words, scale.transpose(-1, -2), mn.transpose(-1, -2)


def dequantize_k(k_codes, k_scale, k_mn, group_size: int, bits: int):
    """(B,H,Dw,T) int32 -> (B,H,D,T) f32 keys (transposed layout)."""
    codes = unpack_codes(k_codes, bits, axis=-2)
    return dequantize_last(codes, k_scale.transpose(-1, -2).float(),
                           k_mn.transpose(-1, -2).float(), group_size)


def quantize_v_block(v: torch.Tensor, group_size: int, bits: int):
    """Quantize a value block v (B, H, T, D), D % gs == 0.

    Returns v_codes (B, H, Dw, T) int32 and v_scale/v_mn (B, H, D//gs, T)
    f32."""
    codes, scale, mn = quantize_last(v, group_size, bits)  # (B,H,T,Dg)
    words = pack_codes(codes, bits, axis=-1)               # (B,H,T,Dw)
    return (words.transpose(-1, -2), scale.transpose(-1, -2),
            mn.transpose(-1, -2))


def dequantize_v(v_codes, v_scale, v_mn, group_size: int, bits: int):
    """(B,H,Dw,T) int32 -> (B,H,T,D) f32 values (natural layout)."""
    codes = unpack_codes(v_codes.transpose(-1, -2), bits, axis=-1)
    return dequantize_last(codes, v_scale.transpose(-1, -2).float(),
                           v_mn.transpose(-1, -2).float(), group_size)
