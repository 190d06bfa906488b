"""Single-token decode attention over the KIVI cache: wrapper of
`csrc/fused_decode.cu` (port of `kivi_tpu/kernels/fused_decode_wide.py`)
and its plain version.

The plain version is the JAX package's split two-half softmax
(`kivi_tpu/core/attention.py:156-216`): logits over the dequantized K
store and the fp K window, one softmax over their concatenation, PV over
the dequantized V store plus the fp V window with V routed by position
(`_gather_v_window_probs`).  The kernel computes the same function split
over T (`csrc/kdec_split.cuh`): one exact softmax per SPLIT-position
split, the partials (m, l, acc) merged in split order.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build

NEG_INF = -1e30


def _gather_v_window_probs(p_a: torch.Tensor, p_b: torch.Tensor,
                           n_k_quant: int, n_v_quant: int,
                           W: int) -> torch.Tensor:
    """Route probabilities of positions [n_v_quant, seq_len) onto value-
    window rows [0, n_v_win).  Position i sits in p_a at slot i when
    i < n_k_quant, else in p_b at slot i - n_k_quant.  Entries beyond the
    valid counts are exact zeros (their logits were masked), so the two
    contributions can simply be added."""
    lead = p_a.shape[:-1]
    delta = n_k_quant - n_v_quant                       # in [0, W]
    pad = p_a.new_zeros((*lead, W))
    a_part = torch.cat([p_a, pad], dim=-1)[..., n_v_quant:n_v_quant + W]
    b_part = p_b.new_zeros((*lead, 2 * W))
    b_part[..., delta:delta + W] = p_b
    return a_part + b_part[..., :W]


def fused_decode_attention_wide_plain(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        n_k_quant: int, n_k_win: int, n_v_quant: int, *, group_size: int,
        k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None,
        hi: Optional[int] = None) -> torch.Tensor:
    """qg (B, Hkv, r, D) + cache arrays -> (B, Hkv, r, D) f32.  lo: (B,)
    int lower position bound per row (left pad / sliding window); hi:
    positions at or past it are not attended (the per-row kernel's
    t_bound)."""
    B, Hkv, r, D = qg.shape
    Tmax = k_codes.shape[-1]
    W = k_win.shape[2]
    sm_scale = 1.0 / math.sqrt(D)
    dev = qg.device
    q = qg.float()

    pos_q = torch.arange(Tmax, device=dev)
    win = torch.arange(W, device=dev)
    k_deq = Q.dequantize_k(k_codes, k_scale, k_mn, group_size, k_bits)
    att_q = torch.einsum("bhrd,bhdt->bhrt", q, k_deq)
    att_q = att_q.masked_fill(pos_q >= n_k_quant, NEG_INF)
    att_w = torch.einsum("bhrd,bhwd->bhrw", q, k_win.float())
    att_w = att_w.masked_fill(win >= n_k_win, NEG_INF)
    if hi is not None:
        att_q = att_q.masked_fill(pos_q >= hi, NEG_INF)
        att_w = att_w.masked_fill(win + n_k_quant >= hi, NEG_INF)
    if lo is not None:
        lo4 = lo.to(device=dev, dtype=torch.int64).reshape(B, 1, 1, 1)
        att_q = att_q.masked_fill(pos_q < lo4, NEG_INF)
        att_w = att_w.masked_fill(win + n_k_quant < lo4, NEG_INF)

    att = torch.cat([att_q, att_w], dim=-1) * sm_scale
    att = att - att.amax(dim=-1, keepdim=True)
    p = torch.exp(att)
    p = p / p.sum(dim=-1, keepdim=True)
    p_a, p_b = p[..., :Tmax], p[..., Tmax:]

    p_vq = p_a.masked_fill(pos_q >= n_v_quant, 0.0)
    v_deq = Q.dequantize_v(v_codes, v_scale, v_mn, group_size, v_bits)
    out_q = torch.einsum("bhrt,bhtd->bhrd", p_vq, v_deq)
    p_vw = _gather_v_window_probs(p_a, p_b, n_k_quant, n_v_quant, W)
    out_w = torch.einsum("bhrw,bhwd->bhrd", p_vw, v_win.float())
    return out_q + out_w


_CHUNK = 128          # positions per chunk of the CUDA kernel
SPLIT = 256           # positions per block of the CUDA kernel (csrc S)
_ROWS = (1, 2, 4, 8)  # query rows per KV head the kernel is built for


def split_plan(n_end: int) -> int:
    """Splits of the host-int kernel: SPLIT-position splits from position
    0 (the lower bound `lo` lives on the device, so no split is skipped
    by the host) up to n_end = n_k_quant + n_k_win, at least one."""
    return max(1, -(-int(n_end) // SPLIT))


def _check_cuda(name, qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                k_win, v_win, group_size, k_bits, v_bits):
    """Raise unless the CUDA kernel takes these inputs."""
    B, H, r, D = qg.shape
    Tmax, W, gs = k_codes.shape[-1], k_win.shape[2], group_size
    sdt = k_scale.dtype
    if (r not in _ROWS or D > 128 or D % 8 or 256 % D or D % gs
            or _CHUNK % gs or gs % 2 or Tmax % 8 or Tmax % gs):
        raise ValueError(f"{name}: unsupported r={r} D={D} gs={gs} "
                         f"Tmax={Tmax}")
    if k_bits not in (2, 4, 8) or v_bits not in (2, 4, 8):
        raise ValueError(f"{name}: bits must be 2, 4 or 8")
    if sdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: scales must be bf16 or f32, got {sdt}")
    _build.check_tensors(name, qg.device, {
        "qg": (qg, (B, H, r, D), torch.bfloat16),
        "k_codes": (k_codes, (B, H, Q.num_words(D, k_bits), Tmax),
                    torch.int32),
        "k_scale": (k_scale, (B, H, Tmax // gs, D), sdt),
        "k_mn": (k_mn, (B, H, Tmax // gs, D), sdt),
        "v_codes": (v_codes, (B, H, Q.num_words(D, v_bits), Tmax),
                    torch.int32),
        "v_scale": (v_scale, (B, H, D // gs, Tmax), sdt),
        "v_mn": (v_mn, (B, H, D // gs, Tmax), sdt),
        "k_win": (k_win, (B, H, W, D), torch.bfloat16),
        "v_win": (v_win, (B, H, W, D), torch.bfloat16),
    })
    _build.check_aligned(name, k_codes, k_scale, k_mn, v_codes, v_scale,
                         v_mn, k_win, v_win)


def fused_decode_attention_wide(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        n_k_quant: int, n_k_win: int, n_v_quant: int, *, group_size: int,
        k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qg (B, Hkv, r, D) + KiviLayerCache arrays -> (B, Hkv, r, D) f32.

    Counters are host ints of a cache state (0 <= n_k_win <= W,
    n_k_quant + n_k_win <= Tmax, n_k_quant + n_k_win - W <= n_v_quant
    <= n_k_quant); lo is an optional (B,) int32 lower position bound.
    On CUDA: qg and the windows bf16, scales bf16 or f32, the cache
    arrays 16-byte aligned, r in (1, 2, 4, 8), D in (8, 16, 32, 64, 128), an even
    group_size dividing D and 128.  One launch: blocks over (split_plan
    SPLIT-position splits, B*Hkv), the last block of each head merging
    its splits in order."""
    if not qg.is_cuda:
        return fused_decode_attention_wide_plain(
            qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
            v_win, n_k_quant, n_k_win, n_v_quant, group_size=group_size,
            k_bits=k_bits, v_bits=v_bits, lo=lo)
    name = "fused_decode_attention_wide"
    _check_cuda(name, qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                k_win, v_win, group_size, k_bits, v_bits)
    B, H, r, D = qg.shape
    Tmax, W = k_codes.shape[-1], k_win.shape[2]
    nkq, nkw, nvq = int(n_k_quant), int(n_k_win), int(n_v_quant)
    if not (0 <= nkw <= W and 0 <= nkq and nkq + nkw <= Tmax
            and max(nkq + nkw - W, 0) <= nvq <= nkq):
        raise ValueError(f"{name}: counters (n_k_quant, n_k_win, "
                         f"n_v_quant) = {(nkq, nkw, nvq)} are no cache "
                         f"state of Tmax={Tmax}, W={W}")
    if lo is not None:
        lo = lo.to(device=qg.device, dtype=torch.int32).contiguous()
        if lo.shape != (B,):
            raise ValueError(f"{name}: lo must have shape ({B},)")
    out = torch.empty((B, H, r, D), dtype=torch.float32, device=qg.device)
    part_acc, part_ml, tickets = _build.workspace(
        qg.device, B * H, split_plan(Tmax), r, D)
    lib = _build.library("fused_decode")
    err = lib.kivi_fused_decode(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), k_win.data_ptr(), v_win.data_ptr(),
        _build.ptr(lo), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), tickets.data_ptr(), B, H, r, D, Tmax, W,
        group_size, k_bits, v_bits, nkq, nkw, nvq,
        int(k_scale.dtype == torch.float32), SPLIT,
        split_plan(nkq + nkw), 1.0 / math.sqrt(D),
        _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
