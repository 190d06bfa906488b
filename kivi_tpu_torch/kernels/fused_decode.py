"""Single-token decode attention over a KIVI cache whose counters differ
per row: wrapper of `csrc/fused_decode_rows.cu` (port of
`fused_decode_attention` in `kivi_tpu/kernels/fused_decode.py`, one
program per (row, KV head)) and its plain version.

The continuous batcher's slot caches, and the engine's caches while it
replays its decode step, carry their counters as (B,) int32 device
tensors, one fill per row.  The kernel reads each row's (n_k_quant,
n_k_win, n_v_quant) from a (B, 3) int32 device tensor, so no counter
passes through the host on the decode path: it runs the split body of
`fused_decode_wide` over the t_bound / SPLIT splits of [0, t_bound),
those outside a row's live positions exiting at once.  A row with no
live position (an empty slot, seq_len 0) returns exact zeros.

`t_bound` (the JAX package's, `kivi_tpu/kernels/fused_decode_wide.py:
564-572`) is a static bound on every row's fill, fixed when a decode
step is captured: Tmax (the default), or a multiple of SPLIT below it.
Positions at or past it are neither read nor attended.  The caller's
contract is JAX's: every row's n_k_quant and n_v_quant + W are at most
t_bound (so its live positions lie below it), and then the result is
the unbounded one.

The plain version is the per-row form of the split two-half softmax of
`fused_decode_wide.fused_decode_attention_wide_plain`: it reads the
counters to the host and runs that function on each row alone, over
the positions below t_bound.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import fused_decode_wide as _wide
from kivi_tpu_torch.kernels.fused_decode_wide import (
    _check_cuda, fused_decode_attention_wide_plain)


def fused_decode_attention_plain(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        counts: torch.Tensor, *, group_size: int, k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None,
        t_bound: Optional[int] = None) -> torch.Tensor:
    """qg (B, Hkv, r, D) + cache arrays, counts (B, 3) int of (n_k_quant,
    n_k_win, n_v_quant) per row -> (B, Hkv, r, D) f32.  lo: (B,) int lower
    position bound per row (left pad / sliding window); t_bound: positions
    at or past it are not attended.  A row whose admitted positions
    [max(lo, 0), min(n_k_quant + n_k_win, t_bound)) are empty gives
    zeros."""
    tb = _build.check_t_bound("fused_decode_attention_plain", t_bound,
                              k_codes.shape[-1], _wide.SPLIT)
    cnt = counts.to(device="cpu", dtype=torch.int64).reshape(-1, 3).tolist()
    los = ([0] * len(cnt) if lo is None
           else lo.to(device="cpu", dtype=torch.int64).reshape(-1).tolist())
    out = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
    for b, (nkq, nkw, nvq) in enumerate(cnt):
        if max(los[b], 0) >= min(nkq + nkw, tb):
            continue
        row = slice(b, b + 1)
        out[row] = fused_decode_attention_wide_plain(
            qg[row], k_codes[row], k_scale[row], k_mn[row], v_codes[row],
            v_scale[row], v_mn[row], k_win[row], v_win[row], nkq, nkw, nvq,
            group_size=group_size, k_bits=k_bits, v_bits=v_bits,
            lo=None if lo is None else lo[row], hi=tb)
    return out


def fused_decode_attention(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        counts: torch.Tensor, *, group_size: int, k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None,
        t_bound: Optional[int] = None) -> torch.Tensor:
    """qg (B, Hkv, r, D) + KiviLayerCache arrays -> (B, Hkv, r, D) f32,
    the counters of row b in counts[b] = (n_k_quant, n_k_win, n_v_quant);
    t_bound: the static fill bound (module docstring), None for Tmax.

    On CUDA: counts a (B, 3) and lo a (B,) int32 tensor on the device
    (read there by each block, never by the host; each row clamped into
    a cache state); qg and the windows bf16, scales bf16 or f32, the
    cache arrays 16-byte aligned, bits 2/4/8, r in (1, 2, 4, 8), D in
    (8, 16, 32, 64, 128), an even group_size dividing D and 128.  One
    launch: blocks over (ceil(t_bound / SPLIT) splits, B*Hkv), the last
    block of each head merging its splits in order."""
    if not qg.is_cuda:
        return fused_decode_attention_plain(
            qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
            v_win, counts, group_size=group_size, k_bits=k_bits,
            v_bits=v_bits, lo=lo, t_bound=t_bound)
    name = "fused_decode_attention"
    _check_cuda(name, qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                k_win, v_win, group_size, k_bits, v_bits)
    B, H, r, D = qg.shape
    counts = counts.to(device=qg.device, dtype=torch.int32).contiguous()
    if counts.shape != (B, 3):
        raise ValueError(f"{name}: counts must have shape ({B}, 3), got "
                         f"{tuple(counts.shape)}")
    if lo is not None:
        lo = lo.to(device=qg.device, dtype=torch.int32).contiguous()
        if lo.shape != (B,):
            raise ValueError(f"{name}: lo must have shape ({B},)")
    Tmax = k_codes.shape[-1]
    tb = _build.check_t_bound(name, t_bound, Tmax, _wide.SPLIT)
    nsplit = _wide.split_plan(tb)
    out = torch.empty((B, H, r, D), dtype=torch.float32, device=qg.device)
    part_acc, part_ml, tickets = _build.workspace(qg.device, B * H, nsplit,
                                                  r, D)
    lib = _build.library("fused_decode_rows")
    err = lib.kivi_fused_decode_rows(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), k_win.data_ptr(), v_win.data_ptr(),
        counts.data_ptr(), _build.ptr(lo), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), B, H,
        r, D, Tmax, k_win.shape[2], group_size, k_bits, v_bits,
        int(k_scale.dtype == torch.float32), _wide.SPLIT, nsplit, tb,
        1.0 / math.sqrt(D), _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
