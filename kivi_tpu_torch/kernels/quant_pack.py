"""Quantize + pack of key and value blocks: wrappers of
`csrc/quant_pack.cu` (port of `kivi_tpu/kernels/quant_pack.py`).

Both take the natural (B, H, T, D) layout (the TPU kernels took the
transposed (B, H, D, T) one because their groups sat on lanes); a CUDA
thread block reads a token tile coalesced along D, so the port needs no
transpose.

Two entries of the same kernel:

  * `quantize_pack_k` / `quantize_pack_v`: fresh outputs in the cache
    layouts of core/quant.py: codes (B, H, Dw, T) int32, K stats
    (B, H, T//gs, D) f32, V stats (B, H, D//gs, T) f32;
  * `quantize_pack_k_into` / `quantize_pack_v_into`: straight into a
    cache's stores (codes (B, H, Dw, Tmax); stats f32 or bf16), at one
    host-int offset along T, or at per-row (B,) int32 device offsets on
    the rows a (B,) bool device predicate selects.  Rows it leaves out
    load nothing and keep their bytes; a selected row's offset is clamped
    into the store as XLA's dynamic_update_slice clamps.  No device value
    is read on the host.

A CPU tensor takes the plain version (core/quant.py, then the write the
cache made before the in-place entry existed); a CUDA tensor launches the
kernel or raises.  Both entries count their launches under
`quantize_pack_k` / `quantize_pack_v`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build

Offset = Union[int, torch.Tensor]


def quantize_pack_k_plain(k: torch.Tensor, group_size: int, bits: int):
    """Plain version: Q.quantize_k_block on the transposed block."""
    return Q.quantize_k_block(k.transpose(-1, -2), group_size, bits)


def quantize_pack_v_plain(v: torch.Tensor, group_size: int, bits: int):
    """Plain version: Q.quantize_v_block."""
    return Q.quantize_v_block(v, group_size, bits)


def masked_store_write(store: torch.Tensor, block: torch.Tensor,
                       start: torch.Tensor, dim: int,
                       pred: Optional[torch.Tensor] = None) -> None:
    """Write block (B, ...) into store (B, ...) in place at per-row
    offsets start (B,) along `dim`, with the CONTENT falling back to the
    store's own bytes on rows where pred (B,) is false.

    As XLA's dynamic_update_slice, which the JAX package relies on, the
    start is clamped into [0, store.shape[dim] - block.shape[dim]]: an
    inactive row at n_win == W, or a full store at n_k_quant == Tmax,
    writes (its own bytes) at the last slice instead of out of range.
    Traffic is O(block) per row; no branch reads a device value."""
    B, n = block.shape[0], block.shape[dim]
    start = start.to(torch.int64).clamp(0, store.shape[dim] - n)
    shape = [1] * block.dim()
    shape[0], shape[dim] = B, n
    idx = (start[:, None] + torch.arange(n, device=store.device)).reshape(
        shape).expand(block.shape)
    block = block.to(store.dtype)
    if pred is not None:
        keep = pred.reshape([B] + [1] * (block.dim() - 1))
        block = torch.where(keep, block, store.gather(dim, idx))
    store.scatter_(dim, idx, block)


def _into_plain(blocks, stores, off: Offset, group_size: int, is_key: bool,
                pred) -> None:
    """Write the plain quantizer's (codes, scale, mn) into the stores:
    slice copies at a host-int offset, selected per-row writes at device
    offsets.  K's stats rows sit at off // gs along axis 2; everything
    else at off along axis 3."""
    for i, (blk, store) in enumerate(zip(blocks, stores)):
        dim = 2 if is_key and i else 3
        o = off // group_size if is_key and i else off
        if isinstance(off, int):
            store.narrow(dim, o, blk.shape[dim]).copy_(blk)
        else:
            masked_store_write(store, blk, o, dim, pred)


def quantize_pack_k_into_plain(k, group_size: int, bits: int, codes, scale,
                               mn, off: Offset, pred=None) -> None:
    """Plain version of quantize_pack_k_into."""
    _into_plain(quantize_pack_k_plain(k, group_size, bits),
                (codes, scale, mn), off, group_size, True, pred)


def quantize_pack_v_into_plain(v, group_size: int, bits: int, codes, scale,
                               mn, off: Offset, pred=None) -> None:
    """Plain version of quantize_pack_v_into."""
    _into_plain(quantize_pack_v_plain(v, group_size, bits),
                (codes, scale, mn), off, group_size, False, pred)


def _name(is_key: bool) -> str:
    return "quantize_pack_k" if is_key else "quantize_pack_v"


def _check_input(x: torch.Tensor, group_size: int, bits: int, is_key: bool):
    name = _name(is_key)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: CUDA kernel takes bf16, got {x.dtype}")
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(f"{name}: need (B, H, T, D) with a contiguous D "
                         f"axis, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    B, H, T, D = x.shape
    gs = group_size
    if (bits not in (2, 4, 8) or T < 1 or gs < 1 or T % gs or D % gs
            or D % (32 // bits)):
        raise ValueError(f"{name}: unsupported T={T} D={D} gs={gs} "
                         f"bits={bits}")


def check_into_args(x, group_size: int, bits: int, codes, scale, mn,
                    off: Offset, pred, is_key: bool) -> None:
    """Raise unless the in-place kernel takes these arguments: x as
    quantize_pack_k/v take it; contiguous stores on x's device (codes
    int32 (B, H, Dw, Tmax); scale and mn both f32 or both bf16, K
    (B, H, Tmax//gs, D), V (B, H, D//gs, Tmax)) with Tmax >= T; a host
    offset in [0, Tmax - T] without a predicate, or (B,) int32 offsets
    and an optional (B,) bool predicate, contiguous, on x's device."""
    name = _name(is_key) + "_into"
    _check_input(x, group_size, bits, is_key)
    B, H, T, D = x.shape
    gs, dev = group_size, x.device
    Tmax = codes.shape[-1] if codes.dim() == 4 else -1
    if Tmax < T or (is_key and Tmax % gs):
        raise ValueError(f"{name}: codes store {tuple(codes.shape)} cannot "
                         f"hold {T} tokens at group size {gs}")
    sdt = scale.dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: stats stores must be f32 or bf16, got "
                        f"{sdt}")
    sshape = (B, H, Tmax // gs, D) if is_key else (B, H, D // gs, Tmax)
    _build.check_tensors(name, dev, {
        "codes": (codes, (B, H, D // (32 // bits), Tmax), torch.int32),
        "scale": (scale, sshape, sdt), "mn": (mn, sshape, sdt)})
    if isinstance(off, int):
        if pred is not None:
            raise TypeError(f"{name}: a predicate needs per-row offsets")
        if not 0 <= off <= Tmax - T:
            raise ValueError(f"{name}: offset {off} + {T} tokens outside "
                             f"the store's {Tmax}")
        return
    spec = {"offsets": (off, (B,), torch.int32)}
    if pred is not None:
        spec["pred"] = (pred, (B,), torch.bool)
    _build.check_tensors(name, dev, spec)


def _launch(x: torch.Tensor, group_size: int, bits: int, is_key: bool):
    _check_input(x, group_size, bits, is_key)
    B, H, T, D = x.shape
    gs = group_size
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
    name = _name(is_key)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return codes, scale, mn


def _launch_into(x, group_size: int, bits: int, codes, scale, mn,
                 off: Offset, pred, is_key: bool) -> None:
    check_into_args(x, group_size, bits, codes, scale, mn, off, pred, is_key)
    B, H, T, D = x.shape
    host = isinstance(off, int)
    lib = _build.library("quant_pack")
    err = lib.kivi_quantize_pack_into(
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), B, H, T, D,
        group_size, bits, int(is_key), codes.data_ptr(), scale.data_ptr(),
        mn.data_ptr(), codes.shape[-1], int(scale.dtype == torch.bfloat16),
        off if host else 0, None if host else off.data_ptr(),
        _build.ptr(pred), _build.stream_handle(x.device))
    name = _name(is_key)
    _build.check(err, name + "_into")
    _build.LAUNCHES[name] += 1


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


def quantize_pack_k_into(k: torch.Tensor, group_size: int, bits: int,
                         codes, scale, mn, off: Offset, pred=None) -> None:
    """Quantize k (B, H, T, D) and write it into the K stores in place:
    codes at `off` along T, stats rows at off // gs; `off` a host int,
    or (B,) int32 per-row offsets with rows selected by pred (B,) bool
    (None: every row).  Bit-equal to quantize_pack_k_into_plain."""
    if not k.is_cuda:
        return quantize_pack_k_into_plain(k, group_size, bits, codes, scale,
                                          mn, off, pred)
    return _launch_into(k, group_size, bits, codes, scale, mn, off, pred,
                        is_key=True)


def quantize_pack_v_into(v: torch.Tensor, group_size: int, bits: int,
                         codes, scale, mn, off: Offset, pred=None) -> None:
    """quantize_pack_k_into for values: codes and stats columns at `off`
    along T.  Bit-equal to quantize_pack_v_into_plain."""
    if not v.is_cuda:
        return quantize_pack_v_into_plain(v, group_size, bits, codes, scale,
                                          mn, off, pred)
    return _launch_into(v, group_size, bits, codes, scale, mn, off, pred,
                        is_key=False)
