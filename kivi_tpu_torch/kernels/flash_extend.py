"""Extend (chunked-prefill) attention over the KIVI cache: wrappers of
`csrc/flash_extend.cu` (port of `flash_extend_attention` in
`kivi_tpu/kernels/flash_extend.py`) and `csrc/flash_extend_qhist.cu`
(port of `flash_extend_qhist`, the same file), and their plain versions.

T1 suffix queries attend the full cached history (quantized stores + fp
windows) plus themselves causally.  The plain version is the JAX
package's `impl="jnp"` extend attention (`kivi_tpu/core/attention.py:
277-364`), in f32; the kernel computes the same function with an online
softmax and never materializes the O(T1 * Tmax) logits.  Both kernels
run their products on the tensor cores with bf16 operands and f32
accumulation, as the Pallas kernels do at their default
compute_dtype=bf16, and share the history's dequantization
(`csrc/hist_tile.cuh`); `utils/tolerance.py` holds them to the plain
versions per query row.

`flash_extend_qhist` computes the quantized-history part alone, as an
unnormalized flash state split over T, for the caller to merge with the
window and self logits (`core.attention._extend_attention_qhist`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels.fused_decode_wide import (NEG_INF,
                                                      _gather_v_window_probs)


@functools.lru_cache(maxsize=32)
def _ws_masks(device, T1: int, W: int, n_k_quant: int, n_k_win: int,
              sliding_window: int):
    """The pad-independent masks of the window + self key block [window
    (W) || suffix keys (T1)] for T1 queries: (drop (T1, W+T1) bool —
    window slots past n_k_win, non-causal suffix keys, keys below each
    query's sliding window —, apos (W+T1,) the keys' absolute positions,
    off_diag (T1, W+T1) bool, everything but the causal diagonal).  The
    same for every layer of a call, so built once (cached)."""
    j = torch.arange(W + T1, device=device)
    i = torch.arange(T1, device=device)[:, None]
    T0 = n_k_quant + n_k_win
    is_win = j < W
    apos = torch.where(is_win, n_k_quant + j, T0 - W + j)
    keep = torch.where(is_win, j < n_k_win, j - W <= i)
    if sliding_window:
        # query i sits at position T0 + i and attends positions
        # > T0 + i - sliding_window
        keep = keep & (apos >= T0 + i - (sliding_window - 1))
    return ~keep, apos, j - W != i


def _extend_ws_logits(qg, k_new, k_win, n_k_quant: int, n_k_win: int, *,
                      sliding_window: Optional[int],
                      pad_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Logits (UNSCALED) of the T1 suffix queries qg (B, Hkv, r, T1, D)
    f32 against the fp key window and their own keys, one block
    (B, Hkv, r, T1, W + T1): window slot w holds position n_k_quant + w,
    suffix key j position seq_len + j.  Masked with NEG_INF: window slots
    past n_k_win, non-causal suffix keys, keys below each query's
    sliding window and below the row's left pad — except the causal
    diagonal, exempt from the pad inside the predicate, so a fully
    padded row's softmax never empties."""
    B, W = qg.shape[0], k_win.shape[2]
    drop, apos, off_diag = _ws_masks(qg.device, qg.shape[3], W, n_k_quant,
                                     n_k_win, sliding_window or 0)
    s = torch.einsum("bhrqd,bhjd->bhrqj", qg,
                     torch.cat([k_win, k_new], dim=2).float())
    if pad_len is not None:
        pad = pad_len.to(device=qg.device).reshape(B, 1, 1, 1, 1)
        drop = drop | ((apos < pad) & off_diag)
    return s.masked_fill(drop, NEG_INF)


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

    att_ws = _extend_ws_logits(q5, k_new, k_win, n_k_quant, n_k_win,
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

    att = torch.cat([att_q, att_ws], dim=-1) * sm_scale
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
    CUDA: qg, windows and k_new/v_new bf16, scales bf16 or f32, all
    16-byte aligned, D <= 128 a multiple of 16, group_size a power of two
    >= 8 dividing n_k_quant; blocks over (128-row query tiles, B*H) on the
    tensor cores (bf16 operands, f32 accumulation, as the Pallas kernel
    at its default compute_dtype), 64 positions a step."""
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
    if (R % t1 or D > 128 or D % 16 or D % gs or gs < 8 or gs & (gs - 1)
            or Tmax % gs):
        raise ValueError(f"{name}: unsupported R={R} t1={t1} D={D} "
                         f"gs={gs} Tmax={Tmax}")
    if k_bits not in (2, 4, 8) or v_bits not in (2, 4, 8):
        raise ValueError(f"{name}: bits must be 2, 4 or 8")
    if sdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: scales must be bf16 or f32, got {sdt}")
    nkq, nkw, nvq = int(n_k_quant), int(n_k_win), int(n_v_quant)
    if not (0 <= nvq <= nkq + nkw <= Tmax and 0 <= nkw <= W
            and nkq + nkw - nvq <= W and nkq % gs == 0):
        raise ValueError(f"{name}: counters n_k_quant={nkq} n_k_win={nkw} "
                         f"n_v_quant={nvq} W={W} Tmax={Tmax} gs={gs}")
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
    _build.check_aligned(name, qg, k_codes, k_scale, k_mn, v_codes,
                         v_scale, v_mn, k_win, v_win, k_new, v_new)
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
        nkq, nkw, nvq, int(sliding_window or 0), int(sdt == torch.float32),
        1.0 / math.sqrt(D), _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


QHIST_SPLIT = 512     # history positions per block (csrc SPLIT)


def flash_extend_qhist_plain(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, v_win,
        n_k_quant: int, n_v_quant: int, seq_len: int, *, group_size: int,
        k_bits: int, v_bits: int, t1: int, sliding_window: int = 0,
        pad_len: Optional[torch.Tensor] = None):
    """Partial flash state of the suffix queries qg (B, H, R, D), R = r*t1
    (row rr*t1 + i is query position seq_len + i), over the quantized
    history [0, n_k_quant).  Returns (acc (B, H, R, D) f32 UNNORMALIZED,
    m (B, H, R), l (B, H, R)), with sm_scale applied to the logits; a row
    that sees no position gives (0, NEG_INF, 0).  V for positions below
    n_v_quant comes from the store, above it from v_win row
    pos - n_v_quant.  Masks: the left pad and, with sliding_window, query
    i's bound seq_len + i - (sliding_window - 1)."""
    B, H, R, D = qg.shape
    r = R // t1
    Tmax = k_codes.shape[-1]
    nkq, nvq = int(n_k_quant), int(n_v_quant)
    dev = qg.device
    q5 = qg.float().reshape(B, H, r, t1, D)
    pos = torch.arange(Tmax, device=dev)
    k_deq = Q.dequantize_k(k_codes, k_scale, k_mn, group_size, k_bits)
    s = torch.einsum("bhrqd,bhdt->bhrqt", q5, k_deq) * (1.0 / math.sqrt(D))
    valid = (pos < nkq).expand(B, 1, 1, t1, Tmax)
    if sliding_window:
        lo = (seq_len + torch.arange(t1, device=dev)
              - (sliding_window - 1)).reshape(1, 1, 1, t1, 1)
        valid = valid & (pos >= lo)
    if pad_len is not None:
        pad = pad_len.to(device=dev, dtype=torch.int64).reshape(B, 1, 1, 1,
                                                                1)
        valid = valid & (pos >= pad)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)
    vcols = Q.dequantize_v(v_codes, v_scale, v_mn, group_size, v_bits)
    vcols[:, :, nvq:nkq] = v_win[:, :, :nkq - nvq].float()
    acc = torch.einsum("bhrqt,bhtd->bhrqd", p, vcols)
    return (acc.reshape(B, H, R, D), m.reshape(B, H, R),
            l.reshape(B, H, R))


def flash_extend_qhist(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, v_win,
        n_k_quant: int, n_v_quant: int, seq_len: int, *, group_size: int,
        k_bits: int, v_bits: int, t1: int, sliding_window: int = 0,
        pad_len: Optional[torch.Tensor] = None):
    """(acc, m, l) of the suffix queries over the quantized history; see
    flash_extend_qhist_plain for the contract.  On CUDA: qg and v_win
    bf16, scales bf16 or f32, all 16-byte aligned, D <= 128 a multiple
    of 16, group_size a power of two >= 8; blocks over (128-row query
    tiles, B*H, QHIST_SPLIT-position splits of [0, n_k_quant)) on the
    tensor cores (bf16 operands, f32 accumulation, as the Pallas kernel
    at its default compute_dtype), merged by a second pass in split
    order."""
    if not qg.is_cuda:
        return flash_extend_qhist_plain(
            qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, v_win,
            n_k_quant, n_v_quant, seq_len, group_size=group_size,
            k_bits=k_bits, v_bits=v_bits, t1=t1,
            sliding_window=sliding_window, pad_len=pad_len)
    name = "flash_extend_qhist"
    B, H, R, D = qg.shape
    Tmax, W, gs = k_codes.shape[-1], v_win.shape[2], group_size
    sdt = k_scale.dtype
    if (R % t1 or D > 128 or D % 16 or D % gs or gs < 8 or gs & (gs - 1)
            or Tmax % gs):
        raise ValueError(f"{name}: unsupported R={R} t1={t1} D={D} "
                         f"gs={gs} Tmax={Tmax}")
    if k_bits not in (2, 4, 8) or v_bits not in (2, 4, 8):
        raise ValueError(f"{name}: bits must be 2, 4 or 8")
    if sdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: scales must be bf16 or f32, got {sdt}")
    nkq, nvq = int(n_k_quant), int(n_v_quant)
    if not 0 <= nvq <= nkq <= min(Tmax, nvq + W):
        raise ValueError(f"{name}: counters n_k_quant={nkq} "
                         f"n_v_quant={nvq} W={W} Tmax={Tmax}")
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
        "v_win": (v_win, (B, H, W, D), torch.bfloat16),
    })
    _build.check_aligned(name, qg, k_codes, k_scale, k_mn, v_codes,
                         v_scale, v_mn, v_win)
    if pad_len is not None:
        pad_len = pad_len.to(device=qg.device, dtype=torch.int32)
        pad_len = pad_len.reshape(B).contiguous()
    nsplit = -(-nkq // QHIST_SPLIT)
    f32 = dict(dtype=torch.float32, device=qg.device)
    part_acc = torch.empty((B * H * nsplit * R * D,), **f32)
    part_ml = torch.empty((2, B * H * nsplit * R), **f32)
    acc = torch.empty((B, H, R, D), **f32)
    m = torch.empty((B, H, R), **f32)
    l = torch.empty((B, H, R), **f32)
    err = _build.library("flash_extend_qhist").kivi_flash_extend_qhist(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), v_win.data_ptr(), _build.ptr(pad_len),
        part_acc.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, R, t1, D, Tmax,
        W, gs, k_bits, v_bits, nkq, nvq, int(seq_len),
        int(sliding_window or 0), int(sdt == torch.float32),
        1.0 / math.sqrt(D), _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return acc, m, l
