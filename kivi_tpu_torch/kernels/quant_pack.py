"""Quantize + pack of key and value blocks: wrappers of
`csrc/quant_pack.cu` (port of `kivi_tpu/kernels/quant_pack.py`).

Both take the natural (B, H, T, D) layout (the TPU kernels took the
transposed (B, H, D, T) one because their groups sat on lanes); a CUDA
thread block reads a token tile coalesced along D, so the port needs no
transpose.  Outputs are the cache layouts of core/quant.py: codes
(B, H, Dw, T) int32, K stats (B, H, T//gs, D) f32, V stats
(B, H, D//gs, T) f32.

A CPU tensor takes the plain version (core/quant.py); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build


def quantize_pack_k_plain(k: torch.Tensor, group_size: int, bits: int):
    """Plain version: Q.quantize_k_block on the transposed block."""
    return Q.quantize_k_block(k.transpose(-1, -2), group_size, bits)


def quantize_pack_v_plain(v: torch.Tensor, group_size: int, bits: int):
    """Plain version: Q.quantize_v_block."""
    return Q.quantize_v_block(v, group_size, bits)


def _launch(x: torch.Tensor, group_size: int, bits: int, is_key: bool):
    name = "quantize_pack_k" if is_key else "quantize_pack_v"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: CUDA kernel takes bf16, got {x.dtype}")
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(f"{name}: need (B, H, T, D) with a contiguous D "
                         f"axis, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    B, H, T, D = x.shape
    gs = group_size
    if bits not in (2, 4, 8) or T % gs or D % gs or D % (32 // bits):
        raise ValueError(f"{name}: unsupported T={T} D={D} gs={gs} "
                         f"bits={bits}")
    Dw = D // (32 // bits)
    dev = x.device
    codes = torch.empty((B, H, Dw, T), dtype=torch.int32, device=dev)
    sshape = (B, H, T // gs, D) if is_key else (B, H, D // gs, T)
    scale = torch.empty(sshape, dtype=torch.float32, device=dev)
    mn = torch.empty(sshape, dtype=torch.float32, device=dev)
    lib = _build.library("quant_pack")
    err = lib.kivi_quantize_pack(
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), B, H, T, D,
        gs, bits, int(is_key), codes.data_ptr(), scale.data_ptr(),
        mn.data_ptr(), _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return codes, scale, mn


def quantize_pack_k(k: torch.Tensor, group_size: int, bits: int):
    """k (B, H, T, D), T % gs == 0 -> (codes (B, H, Dw, T) int32,
    scale/mn (B, H, T//gs, D) f32), bit-equal to quantize_pack_k_plain."""
    if not k.is_cuda:
        return quantize_pack_k_plain(k, group_size, bits)
    return _launch(k, group_size, bits, is_key=True)


def quantize_pack_v(v: torch.Tensor, group_size: int, bits: int):
    """v (B, H, T, D), D % gs == 0 -> (codes (B, H, Dw, T) int32,
    scale/mn (B, H, D//gs, T) f32), bit-equal to quantize_pack_v_plain."""
    if not v.is_cuda:
        return quantize_pack_v_plain(v, group_size, bits)
    return _launch(v, group_size, bits, is_key=False)
