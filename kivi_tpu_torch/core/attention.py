"""KIVI attention over the static split cache, and exact prefill
attention: port of the main-path subset of `kivi_tpu/core/attention.py`
(`decode_attention`, `extend_attention`, `prefill_attention`).
`decode_attention` takes the engine's caches (host-int counters) and
the continuous batcher's slot caches (per-row device counters) alike.

Decode attention is the KIVI reference's two-half softmax (its
`models/llama_kivi.py:115-129, 167-172, 323-399`):

    att = softmax([ q x dequant(K_quant)  ||  q x K_window ] / sqrt(D))
    out = att[..., :n_vq] x dequant(V_quant) + att[..., n_vq:] x V_window

with the value window routed by position (`_gather_v_window_probs`),
since the K and V stores can hold different numbers of quantized
tokens.  Extend attention adds the causal self block of the T1 suffix
queries.

The plain versions and the JAX package's helpers they use
(`_gather_v_window_probs` in `kernels/fused_decode_wide.py`,
`_extend_ws_logits` in `kernels/flash_extend.py`) live beside their
kernels, so each kernel module holds its own contract.  CPU tensors
take the plain versions, CUDA tensors the kernels.

GQA: query heads are folded into the KV-head batch (B, Hkv, r, D) and
the quantized operands are never materialized per query head.
"""

from __future__ import annotations

from typing import Optional

import torch

from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.kernels.flash import flash_attention
from kivi_tpu_torch.kernels.flash_extend import flash_extend_attention
from kivi_tpu_torch.kernels.fused_decode import fused_decode_attention
from kivi_tpu_torch.kernels.fused_decode_wide import \
    fused_decode_attention_wide


def decode_attention(q: torch.Tensor, cache: KiviLayerCache,
                     qcfg: QuantConfig, *,
                     sliding_window: Optional[int] = None,
                     pad_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, Hq, 1, D) post-RoPE queries for the token just appended to the
    cache (position cache.seq_len - 1).  Returns (B, Hq, 1, D) f32.

    pad_len: optional (B,) int — LEFT-padding slots at the front of each
    row's cache, masked as positions < pad_len.  A sliding window is the
    same kind of lower position bound (position t attends positions
    > t - sliding_window), so both fold into one per-row `lo`.

    Host-int counters (the engine) go to `fused_decode_attention_wide`;
    a slot cache's per-row device counters (the continuous batcher) go
    to `fused_decode_attention`, which reads them on the device."""
    B, Hq, M, D = q.shape
    assert M == 1, "decode_attention is single-token"
    Hkv = cache.k_win.shape[1]
    r = Hq // Hkv
    per_row = isinstance(cache.n_k_quant, torch.Tensor)
    lo = None
    if pad_len is not None:
        lo = pad_len.to(device=q.device, dtype=torch.int32).reshape(B)
    if sliding_window is not None:
        if per_row:
            swa_lo = torch.clamp(cache.seq_len - sliding_window, min=0)
            lo = swa_lo if lo is None else torch.maximum(lo, swa_lo)
        else:
            swa_lo = max(cache.seq_len - sliding_window, 0)
            lo = (torch.full((B,), swa_lo, dtype=torch.int32,
                             device=q.device)
                  if lo is None else torch.clamp(lo, min=swa_lo))
    args = (q.reshape(B, Hkv, r, D).contiguous(), cache.k_codes,
            cache.k_scale, cache.k_mn, cache.v_codes, cache.v_scale,
            cache.v_mn, cache.k_win, cache.v_win)
    kw = dict(group_size=qcfg.group_size, k_bits=qcfg.k_bits,
              v_bits=qcfg.v_bits, lo=lo)
    if per_row:
        counts = torch.stack([cache.n_k_quant, cache.n_k_win,
                              cache.n_v_quant], dim=1)
        out = fused_decode_attention(*args, counts, **kw)
    else:
        out = fused_decode_attention_wide(
            *args, cache.n_k_quant, cache.n_k_win, cache.n_v_quant, **kw)
    return out.reshape(B, Hq, 1, D)


def extend_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: KiviLayerCache,
                     qcfg: QuantConfig, *,
                     sliding_window: Optional[int] = None,
                     pad_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Multi-token continuation attention: T1 suffix queries attend the
    full cached history (quantized stores + fp windows) plus themselves
    causally — the chunked-prefill attention step.

    q: (B, Hq, T1, D); k_new/v_new: (B, Hkv, T1, D) post-RoPE, NOT yet
    appended to the cache.  Returns (B, Hq, T1, D) f32.

    pad_len: (B,) int — rows were LEFT-padded by this many slots; cache
    positions [0, pad) are masked across all three halves.  Self
    positions keep the causal diagonal, so the softmax never empties even
    on a fully padded chunk."""
    B, Hq, T1, D = q.shape
    Hkv = cache.k_win.shape[1]
    r = Hq // Hkv
    out = flash_extend_attention(
        q.reshape(B, Hkv, r * T1, D).contiguous(), cache.k_codes,
        cache.k_scale, cache.k_mn, cache.v_codes, cache.v_scale,
        cache.v_mn, cache.k_win, cache.v_win, k_new.contiguous(),
        v_new.contiguous(), cache.n_k_quant, cache.n_k_win,
        cache.n_v_quant, group_size=qcfg.group_size, k_bits=qcfg.k_bits,
        v_bits=qcfg.v_bits, t1=T1, sliding_window=sliding_window or 0,
        pad_len=pad_len)
    return out.reshape(B, Hq, T1, D)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, sliding_window: Optional[int] = None,
                      pad_len: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Exact causal attention for one-shot prefill (full precision, no
    quantization): the reference's exact-prefill design, attention first
    and the prompt's K/V quantized afterwards.

    q: (B, Hq, T, D); k, v: (B, Hkv, T, D).  Returns (B, Hq, T, D): f32
    from the plain version (CPU), bf16 from the kernel (CUDA), rounded
    once from its f32 accumulator.

    pad_len: optional (B,) int left pad per row; key positions
    < pad_len[b] are masked.  Query rows at padded positions softmax
    over an empty set and emit exactly 0."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           sliding_window=sliding_window, pad_len=pad_len)
