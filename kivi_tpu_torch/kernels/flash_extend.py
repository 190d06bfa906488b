"""Extend (chunked-prefill) attention over the KIVI cache: wrapper of
`csrc/flash_extend.cu` (port of `flash_extend_attention` in
`kivi_tpu/kernels/flash_extend.py`) and its plain version.

T1 suffix queries attend the full cached history (quantized stores + fp
windows) plus themselves causally.  The plain version is the JAX
package's `impl="jnp"` extend attention (`kivi_tpu/core/attention.py:
277-364`); the kernel computes the same function with an online softmax
and never materializes the O(T1 * Tmax) logits.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels.fused_decode_wide import (NEG_INF,
                                                      _gather_v_window_probs)


def _extend_ws_logits(qg, k_new, k_win, n_k_quant: int, n_k_win: int, *,
                      sliding_window: Optional[int],
                      pad_len: Optional[torch.Tensor]):
    """The window + causal-self logit halves of extend attention, masked
    with NEG_INF (UNSCALED).  qg (B, Hkv, r, T1, D) f32."""
    B = qg.shape[0]
    T1 = qg.shape[3]
    W = k_win.shape[2]
    T0 = n_k_quant + n_k_win
    dev = qg.device

    win_w = torch.arange(W, device=dev)
    att_w = torch.einsum("bhrqd,bhwd->bhrqw", qg, k_win.float())
    att_w = att_w.masked_fill(win_w >= n_k_win, NEG_INF)

    att_s = torch.einsum("bhrqd,bhjd->bhrqj", qg, k_new.float())
    qi = torch.arange(T1, device=dev)[:, None]
    kj = torch.arange(T1, device=dev)[None, :]
    att_s = att_s.masked_fill(kj > qi, NEG_INF)

    if sliding_window:
        # query i sits at position T0 + i and attends positions
        # > T0 + i - sliding_window across all halves
        lo = (T0 + torch.arange(T1, device=dev)
              - (sliding_window - 1)).reshape(1, 1, 1, T1, 1)
        att_w = att_w.masked_fill(win_w + n_k_quant < lo, NEG_INF)
        att_s = att_s.masked_fill(kj + T0 < lo, NEG_INF)

    if pad_len is not None:
        pad = pad_len.to(device=dev, dtype=torch.int64).reshape(B, 1, 1, 1,
                                                                1)
        att_w = att_w.masked_fill(win_w + n_k_quant < pad, NEG_INF)
        # the causal diagonal is exempt from the pad mask (inside the
        # predicate), so a fully padded row's softmax never empties
        keep = (kj + T0 >= pad) | (kj == qi)
        att_s = att_s.masked_fill(~keep, NEG_INF)
    return att_w, att_s


def flash_extend_attention_plain(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        k_new, v_new, n_k_quant: int, n_k_win: int, n_v_quant: int, *,
        group_size: int, k_bits: int, v_bits: int, t1: int,
        sliding_window: int = 0,
        pad_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qg (B, Hkv, R, D), R = r * t1 (row rr*t1 + i); k_new/v_new
    (B, Hkv, t1, D) not yet in the cache.  Returns (B, Hkv, R, D) f32."""
    B, Hkv, R, D = qg.shape
    r = R // t1
    Tmax = k_codes.shape[-1]
    W = k_win.shape[2]
    T0 = n_k_quant + n_k_win
    sm_scale = 1.0 / math.sqrt(D)
    dev = qg.device
    q5 = qg.float().reshape(B, Hkv, r, t1, D)

    att_w, att_s = _extend_ws_logits(q5, k_new, k_win, n_k_quant, n_k_win,
                                     sliding_window=sliding_window,
                                     pad_len=pad_len)

    pos_q = torch.arange(Tmax, device=dev)
    k_deq = Q.dequantize_k(k_codes, k_scale, k_mn, group_size, k_bits)
    att_q = torch.einsum("bhrqd,bhdt->bhrqt", q5, k_deq)
    att_q = att_q.masked_fill(pos_q >= n_k_quant, NEG_INF)
    if sliding_window:
        lo = (T0 + torch.arange(t1, device=dev)
              - (sliding_window - 1)).reshape(1, 1, 1, t1, 1)
        att_q = att_q.masked_fill(pos_q < lo, NEG_INF)
    if pad_len is not None:
        pad = pad_len.to(device=dev, dtype=torch.int64).reshape(B, 1, 1, 1,
                                                                1)
        att_q = att_q.masked_fill(pos_q < pad, NEG_INF)

    att = torch.cat([att_q, att_w, att_s], dim=-1) * sm_scale
    att = att - att.amax(dim=-1, keepdim=True)
    p = torch.exp(att)
    p = p / p.sum(dim=-1, keepdim=True)
    p_a = p[..., :Tmax]
    p_b = p[..., Tmax:Tmax + W]
    p_s = p[..., Tmax + W:]

    p_vq = p_a.masked_fill(pos_q >= n_v_quant, 0.0)
    v_deq = Q.dequantize_v(v_codes, v_scale, v_mn, group_size, v_bits)
    out_q = torch.einsum("bhrqt,bhtd->bhrqd", p_vq, v_deq)
    p_vw = _gather_v_window_probs(p_a, p_b, n_k_quant, n_v_quant, W)
    out_w = torch.einsum("bhrqw,bhwd->bhrqd", p_vw, v_win.float())
    out_s = torch.einsum("bhrqj,bhjd->bhrqd", p_s, v_new.float())
    return (out_q + out_w + out_s).reshape(B, Hkv, R, D)


def flash_extend_attention(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        k_new, v_new, n_k_quant: int, n_k_win: int, n_v_quant: int, *,
        group_size: int, k_bits: int, v_bits: int, t1: int,
        sliding_window: int = 0,
        pad_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full extend attention (history + windows + causal self block),
    normalized.  See flash_extend_attention_plain for the contract.  On
    CUDA: qg, windows and k_new/v_new bf16, scales bf16 or f32,
    D <= 128."""
    if not qg.is_cuda:
        return flash_extend_attention_plain(
            qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
            v_win, k_new, v_new, n_k_quant, n_k_win, n_v_quant,
            group_size=group_size, k_bits=k_bits, v_bits=v_bits, t1=t1,
            sliding_window=sliding_window, pad_len=pad_len)
    name = "flash_extend_attention"
    B, H, R, D = qg.shape
    Tmax, W, gs = k_codes.shape[-1], k_win.shape[2], group_size
    sdt = k_scale.dtype
    if R % t1 or D > 128 or D % 16 or D % gs:
        raise ValueError(f"{name}: unsupported R={R} t1={t1} D={D} "
                         f"gs={gs}")
    if k_bits not in (2, 4, 8) or v_bits not in (2, 4, 8):
        raise ValueError(f"{name}: bits must be 2, 4 or 8")
    if sdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: scales must be bf16 or f32, got {sdt}")
    _build.check_tensors(name, qg.device, {
        "qg": (qg, (B, H, R, D), torch.bfloat16),
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
        "k_new": (k_new, (B, H, t1, D), torch.bfloat16),
        "v_new": (v_new, (B, H, t1, D), torch.bfloat16),
    })
    if pad_len is not None:
        pad_len = pad_len.to(device=qg.device, dtype=torch.int32)
        pad_len = pad_len.reshape(B).contiguous()
    out = torch.empty((B, H, R, D), dtype=torch.float32, device=qg.device)
    lib = _build.library("flash_extend")
    err = lib.kivi_flash_extend(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), k_win.data_ptr(), v_win.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), _build.ptr(pad_len),
        out.data_ptr(), B, H, R, t1, D, Tmax, W, gs, k_bits, v_bits,
        int(n_k_quant), int(n_k_win), int(n_v_quant),
        int(sliding_window or 0), int(sdt == torch.float32),
        1.0 / math.sqrt(D), _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
