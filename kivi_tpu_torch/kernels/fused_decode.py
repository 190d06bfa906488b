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

`prefix=` / `shared=`: the second half of the shared-prefix route
(`decode_prefix.shared_decode_attention`).  Every row then attends only
its positions at or above `shared` (its lower bound is max(lo, shared)),
and the prefix pass's partial flash state over [0, shared) is merged in
before the row's own splits; the kernel's grid starts at the split that
holds `shared`.  The plain version computes each row's own state over
those positions in f32 and merges it with the given partials.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import fused_decode_wide as _wide
from kivi_tpu_torch.kernels.fused_decode_wide import (
    _check_cuda, fused_decode_attention_wide_plain)


def fused_decode_attention_plain(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        counts: torch.Tensor, *, group_size: int, k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None,
        t_bound: Optional[int] = None, prefix: Optional[tuple] = None,
        shared: int = 0) -> torch.Tensor:
    """qg (B, Hkv, r, D) + cache arrays, counts (B, 3) int of (n_k_quant,
    n_k_win, n_v_quant) per row -> (B, Hkv, r, D) f32.  lo: (B,) int lower
    position bound per row (left pad / sliding window); t_bound: positions
    at or past it are not attended.  A row whose admitted positions
    [max(lo, 0), min(n_k_quant + n_k_win, t_bound)) are empty gives
    zeros.  prefix: (acc (Hkv, n, B*r, D), ml (Hkv, n, B*r, 2)) f32, the
    partial flash states of n splits of [0, shared) (row b*r + rr holds
    qg[b, :, rr]; `decode_prefix`), merged with each row's own positions
    [max(lo, shared), ...) (module docstring)."""
    tb = _build.check_t_bound("fused_decode_attention_plain", t_bound,
                              k_codes.shape[-1], _wide.SPLIT)
    cnt = counts.to(device="cpu", dtype=torch.int64).reshape(-1, 3).tolist()
    los = ([0] * len(cnt) if lo is None
           else lo.to(device="cpu", dtype=torch.int64).reshape(-1).tolist())
    if prefix is not None:
        return _route_plain(qg, k_codes, k_scale, k_mn, v_codes, v_scale,
                            v_mn, k_win, v_win, cnt, los, tb, prefix,
                            int(shared), group_size, k_bits, v_bits)
    if shared:
        raise ValueError("fused_decode_attention_plain: shared= needs "
                         "prefix=")
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


def _own_state_plain(q, kc, ks, km, vc, vs, vm, kw, vw, nkq: int,
                     nkw: int, nvq: int, a: int, e: int, group_size: int,
                     k_bits: int, v_bits: int) -> tuple:
    """One row's unnormalized flash state over its positions [a, e): q
    (H, r, D) f32 and the row's arrays (no batch axis); K from the store
    below nkq, from the window above; V from the store below nvq, from
    the window above.  Returns (acc (H, r, D), m (H, r), l (H, r)), m
    NEG_INF where l is 0."""
    T = kc.shape[-1]
    K = Q.dequantize_k(kc[None], ks[None], km[None], group_size,
                       k_bits)[0].transpose(-1, -2).clone()
    K[:, nkq:nkq + nkw] = kw[:, :nkw].float()
    V = Q.dequantize_v(vc[None], vs[None], vm[None], group_size,
                       v_bits)[0].clone()
    V[:, nvq:nkq + nkw] = vw[:, :nkq + nkw - nvq].float()
    pos = torch.arange(T, device=q.device)
    valid = (pos >= a) & (pos < e)
    s = torch.einsum("hrd,htd->hrt", q, K) * (1.0 / math.sqrt(q.shape[-1]))
    s = s.masked_fill(~valid, _wide.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    return (torch.einsum("hrt,htd->hrd", p, V),
            torch.where(l > 0, m, torch.full_like(m, _wide.NEG_INF)), l)


def _merge_states(acc: torch.Tensor, m: torch.Tensor,
                 l: torch.Tensor) -> torch.Tensor:
    """Normalized attention from partial flash states stacked on axis 1
    (acc (H, n, r, D), m and l (H, n, r)): states with l = 0 add
    nothing; a row with none gives zeros."""
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, _wide.NEG_INF)).amax(dim=1)
    c = torch.where(live, torch.exp(m - M[:, None]), torch.zeros_like(m))
    L = (l * c).sum(dim=1)
    A = (acc * c[..., None]).sum(dim=1)
    return torch.where(L[..., None] > 0, A / torch.where(L > 0, L, 1.0)[
        ..., None], torch.zeros_like(A))


def _route_plain(qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
                 v_win, cnt, los, tb: int, prefix: tuple, shared: int,
                 group_size: int, k_bits: int, v_bits: int) -> torch.Tensor:
    """The plain version under prefix=: each row's own state over
    [max(lo, shared), min(n_k_quant + n_k_win, t_bound)) merged after the
    prefix's split states of its query rows."""
    B, H, r, D = qg.shape
    acc_x, ml_x = prefix
    out = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
    for b, (nkq, nkw, nvq) in enumerate(cnt):
        a, e = max(los[b], shared, 0), min(nkq + nkw, tb)
        acc, m, l = _own_state_plain(
            qg[b].float(), k_codes[b], k_scale[b], k_mn[b], v_codes[b],
            v_scale[b], v_mn[b], k_win[b], v_win[b], nkq, nkw, nvq, a, e,
            group_size, k_bits, v_bits)
        rows = slice(b * r, (b + 1) * r)
        out[b] = _merge_states(
            torch.cat([acc_x[:, :, rows].float(), acc[:, None]], dim=1),
            torch.cat([ml_x[:, :, rows, 0].float(), m[:, None]], dim=1),
            torch.cat([ml_x[:, :, rows, 1].float(), l[:, None]], dim=1))
    return out


def fused_decode_attention(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        counts: torch.Tensor, *, group_size: int, k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None,
        t_bound: Optional[int] = None, prefix: Optional[tuple] = None,
        shared: int = 0) -> torch.Tensor:
    """qg (B, Hkv, r, D) + KiviLayerCache arrays -> (B, Hkv, r, D) f32,
    the counters of row b in counts[b] = (n_k_quant, n_k_win, n_v_quant);
    t_bound: the static fill bound (module docstring), None for Tmax.

    On CUDA: counts a (B, 3) and lo a (B,) int32 tensor on the device
    (read there by each block, never by the host; each row clamped into
    a cache state); qg and the windows bf16, scales bf16 or f32, the
    cache arrays 16-byte aligned, bits 2/4/8, r in (1, 2, 4, 8), D in
    (8, 16, 32, 64, 128), an even group_size dividing D and 128.  One
    launch: blocks over (ceil(t_bound / SPLIT) splits, B*Hkv), the last
    block of each head merging its splits in order; under prefix= the
    splits from the one holding `shared` on, the prefix's partials merged
    first (contiguous f32 on the device, `decode_prefix`'s layout)."""
    if not qg.is_cuda:
        return fused_decode_attention_plain(
            qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
            v_win, counts, group_size=group_size, k_bits=k_bits,
            v_bits=v_bits, lo=lo, t_bound=t_bound, prefix=prefix,
            shared=shared)
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
    px_acc = px_ml = None
    shared = int(shared)
    if prefix is not None:
        px_acc, px_ml = prefix
        n = px_acc.shape[1] if px_acc.dim() == 4 else 0
        _build.check_tensors(name, qg.device, {
            "prefix acc": (px_acc, (H, n, B * r, D), torch.float32),
            "prefix ml": (px_ml, (H, n, B * r, 2), torch.float32)})
        if n < 1 or not 0 < shared <= tb:
            raise ValueError(f"{name}: a prefix of {n} splits over "
                             f"[0, {shared}) with t_bound {tb}")
    elif shared:
        raise ValueError(f"{name}: shared= needs prefix=")
    out = torch.empty((B, H, r, D), dtype=torch.float32, device=qg.device)
    part_acc, part_ml, tickets = _build.workspace(qg.device, B * H, nsplit,
                                                  r, D)
    lib = _build.library("fused_decode_rows")
    err = lib.kivi_fused_decode_rows(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), k_win.data_ptr(), v_win.data_ptr(),
        counts.data_ptr(), _build.ptr(lo), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
        _build.ptr(px_acc), _build.ptr(px_ml), B, H, r, D, Tmax,
        k_win.shape[2], group_size, k_bits, v_bits,
        int(k_scale.dtype == torch.float32), _wide.SPLIT, nsplit, tb,
        shared, 0 if px_acc is None else px_acc.shape[1],
        1.0 / math.sqrt(D), _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
