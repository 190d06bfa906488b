"""One-shot causal prefill attention: wrapper of `csrc/flash.cu` (port of
`flash_attention` in `kivi_tpu/kernels/flash.py`) and its plain version.

Exact causal attention in full precision: query position t attends key
positions p <= t, above the row's left pad and, with a sliding window,
p > t - window.  GQA by index: query head h reads KV head h // r, never
expanded per query head.  Query rows at padded positions softmax over an
empty set and come out exactly 0 (unlike extend attention, which keeps
the causal diagonal for them).

The plain version is the JAX package's `impl="jnp"` prefill attention
(`kivi_tpu/core/attention.py:465-488`), all in f32, and returns f32.
The kernel runs both products on the tensor cores with bf16 operands and
f32 accumulation, rounding p to bf16 before PV as the Pallas kernel does
(`kivi_tpu/kernels/flash.py:100-103`), and rounds its output to bf16
once (`:197-199`); the model casts the attention output to bf16 next.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.kernels import _build

NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, sliding_window: Optional[int] = None,
                          pad_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q (B, Hq, T, D); k, v (B, Hkv, T, D) -> (B, Hq, T, D) f32.
    pad_len: optional (B,) int left pad per row."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    r = Hq // Hkv
    dev = q.device
    qg = q.float().reshape(B, Hkv, r, T, D)
    att = torch.einsum("bhrqd,bhkd->bhrqk", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(T, device=dev)[:, None]
    kpos = torch.arange(T, device=dev)[None, :]
    mask = kpos <= qpos
    if sliding_window:
        mask = mask & (kpos > qpos - sliding_window)
    if pad_len is not None:
        pad = pad_len.to(device=dev, dtype=torch.int64).reshape(B, 1, 1, 1,
                                                                1)
        mask = mask & (kpos >= pad)
        att = att.masked_fill(~mask, NEG_INF)
        # fully masked query rows (padding) emit 0, not a uniform average
        p = torch.where(mask.any(dim=-1, keepdim=True),
                        torch.softmax(att, dim=-1), 0.0)
    else:
        p = torch.softmax(att.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhrqk,bhkd->bhrqd", p, v.float())
    return out.reshape(B, Hq, T, D)


def flash_attention(q, k, v, *, sliding_window: Optional[int] = None,
                    pad_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal prefill attention; see flash_attention_plain for the
    contract.  Returns f32 on the CPU (plain version) and bf16 on CUDA
    (the kernel: q, k, v contiguous bf16 16-byte aligned, D <= 128 a
    multiple of 16, Hq % Hkv == 0)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, sliding_window=sliding_window,
                                     pad_len=pad_len)
    name = "flash_attention"
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    if D > 128 or D % 16 or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: unsupported D={D} Hq={Hq} Hkv={Hkv}")
    _build.check_tensors(name, q.device, {
        "q": (q, (B, Hq, T, D), torch.bfloat16),
        "k": (k, (B, Hkv, T, D), torch.bfloat16),
        "v": (v, (B, Hkv, T, D), torch.bfloat16),
    })
    _build.check_aligned(name, q, k, v)
    if pad_len is not None:
        pad_len = pad_len.to(device=q.device, dtype=torch.int32)
        pad_len = pad_len.reshape(B).contiguous()
    out = torch.empty((B, Hq, T, D), dtype=torch.bfloat16, device=q.device)
    lib = _build.library("flash")
    err = lib.kivi_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(pad_len),
        out.data_ptr(), B, Hq, Hkv, T, D, int(sliding_window or 0),
        1.0 / math.sqrt(D), _build.stream_handle(q.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def wgmma_tile_plain(a, b, mode: str) -> torch.Tensor:
    """mode "qk": a (64, 128) @ b (n, 128).T; "pv": a (64, n) @ b (n,
    128).  f32."""
    return a.float() @ (b.float().T if mode == "qk" else b.float())


def wgmma_tile(a, b, mode: str) -> torch.Tensor:
    """The tensor-core tile of `csrc/attn_wgmma.cuh` alone, for a card
    test, at every shape the two kernels give it: one warpgroup computes
    S = Q K^T (mode "qk": a (64, 128), b (n, 128), n in 16/64/128, both
    from shared memory) or O = P V (mode "pv": a (64, n) taken through the
    accumulator fragment into the A registers as P is, b (n, 128) read
    transposed, n in 64/128); bf16 operands, f32 out.  A CPU tensor takes
    the plain version."""
    if not a.is_cuda:
        return wgmma_tile_plain(a, b, mode)
    name = "wgmma_tile"
    n, dp = b.shape
    if mode not in ("qk", "pv") or dp != 128 or n not in (
            (16, 64, 128) if mode == "qk" else (64, 128)):
        raise ValueError(f"{name}: unsupported mode={mode} b "
                         f"{tuple(b.shape)}")
    _build.check_tensors(name, a.device, {
        "a": (a, (64, dp) if mode == "qk" else (64, n), torch.bfloat16),
        "b": (b, (n, dp), torch.bfloat16)})
    out = torch.empty((64, n if mode == "qk" else dp), dtype=torch.float32,
                      device=a.device)
    err = _build.library("flash").kivi_wgmma_tile(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
        0 if mode == "qk" else 1, _build.stream_handle(a.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
