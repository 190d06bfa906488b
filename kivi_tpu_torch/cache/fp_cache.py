"""Full-precision KV cache, the fp16-cache baseline: port of
`kivi_tpu/cache/fp_cache.py`.

The same static preallocation as the KIVI cache, so the two engines are
compared like for like: K is stored TRANSPOSED, (B, H, D, Tmax), the
token axis last as in the KIVI stores; V is (B, H, Tmax, D).  Appends
`copy_` into slices of the preallocated tensors in place.  `length` is a
host int, uniform over the batch (the engine), or a (B,) int32 device
tensor, one length per row (the continuous batcher's slot caches,
`init_fp_slot_cache`, updated by `fp_append_masked`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.core.attention import t_bound_for
from kivi_tpu_torch.kernels.fp_decode import (NEG_INF,
                                               fp_decode_attention_kernel)
from kivi_tpu_torch.kernels.quant_pack import masked_store_write
from kivi_tpu_torch.utils.device import resolve_device
from kivi_tpu_torch.utils.guards import checking, debug_check


@dataclasses.dataclass
class FpLayerCache:
    """k: (B, H, D, Tmax) transposed keys; v: (B, H, Tmax, D); length:
    count of valid tokens, a host int or (B,) int32 device tensor."""

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor] = 0

    @property
    def seq_len(self) -> Union[int, torch.Tensor]:
        return self.length

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[-1]


def init_fp_cache(batch: int, num_kv_heads: int, head_dim: int,
                  max_seq_len: int, dtype=torch.bfloat16,
                  device=None) -> FpLayerCache:
    """An empty cache preallocated at max_seq_len, on CUDA unless `device`
    says otherwise (utils.device.resolve_device)."""
    device = resolve_device(device)
    B, H, D, T = batch, num_kv_heads, head_dim, max_seq_len
    return FpLayerCache(
        k=torch.zeros((B, H, D, T), dtype=dtype, device=device),
        v=torch.zeros((B, H, T, D), dtype=dtype, device=device))


def init_fp_slot_cache(num_slots: int, num_kv_heads: int, head_dim: int,
                       max_seq_len: int, dtype=torch.bfloat16,
                       device=None) -> FpLayerCache:
    """An empty slot cache: one row per slot, `length` a (num_slots,)
    int32 tensor on the device."""
    cache = init_fp_cache(num_slots, num_kv_heads, head_dim, max_seq_len,
                          dtype, device)
    cache.length = torch.zeros(num_slots, dtype=torch.int32,
                               device=cache.k.device)
    return cache


def fp_append(cache: FpLayerCache, k_new, v_new) -> FpLayerCache:
    """Append T tokens of (B, H, T, D) in place at `length`."""
    t = k_new.shape[-2]
    off = cache.length
    assert off + t <= cache.max_seq_len, "cache too small"
    cache.k[..., off:off + t].copy_(k_new.transpose(-1, -2))
    cache.v[:, :, off:off + t].copy_(v_new)
    cache.length = off + t
    return cache


def fp_append_masked(cache: FpLayerCache, k_new, v_new,
                     active: Optional[torch.Tensor] = None) -> FpLayerCache:
    """`fp_append` of T tokens (B, H, T, D) into a cache with per-row
    lengths on the device (a slot cache, or the engine's cache while it
    replays its decode step), each row at its own length; rows where
    active (B,) is false keep their length (None: every row advances).
    They still write, at the frozen length, beyond the valid count and
    hence invisible to attention, as in the JAX package.  The start is
    clamped into [0, Tmax - T] (XLA's dynamic_update_slice), so a full
    row never writes out of range.  A host-int length takes fp_append."""
    if not isinstance(cache.length, torch.Tensor):
        return fp_append(cache, k_new, v_new)
    t = k_new.shape[-2]
    masked_store_write(cache.k, k_new.transpose(-1, -2), cache.length, 3)
    masked_store_write(cache.v, v_new, cache.length, 2)
    cache.length += t if active is None else active.to(
        device=cache.k.device, dtype=torch.int32).reshape(-1) * t
    return cache


def rollback(cache: FpLayerCache, n_tokens,
             active: Optional[torch.Tensor] = None) -> FpLayerCache:
    """The fp cache's counter rollback to n_tokens committed tokens (the
    speculative decoders', kivi_tpu/serving/speculative.py:141-147,
    spec_batcher.py:298-311): the length alone, since the rows past it
    are invisible to attention.  A host-int length takes an int; a
    per-row device length an int or a (B,) tensor, written in place
    (rows where active is false keep theirs)."""
    if not isinstance(cache.length, torch.Tensor):
        cache.length = int(n_tokens)
        return cache
    new = torch.as_tensor(n_tokens, dtype=cache.length.dtype,
                          device=cache.length.device).expand_as(cache.length)
    if active is not None:
        act = active.to(device=cache.length.device,
                        dtype=torch.bool).reshape(-1)
        new = torch.where(act, new, cache.length)
    cache.length.copy_(new)
    return cache


def counters_to_device(caches, buf: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """kivi_cache.counters_to_device for fp caches: every layer's host-int
    length into a row of buf (L, 1, B) int32, one copy."""
    return KC.counters_to_device(caches, buf, names=("length",))


def counters_to_host(caches, buf: torch.Tensor) -> None:
    """kivi_cache.counters_to_host for fp caches: one read of buf."""
    KC.counters_to_host(caches, buf, names=("length",))


def fp_extend_attention(q, k_new, v_new, cache: FpLayerCache,
                        sliding_window: Optional[int] = None,
                        pad_len: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Multi-token continuation attention over the fp cache: T1 suffix
    queries attend the cached history [0, length) plus themselves
    causally (the twin of core.attention.extend_attention).

    q: (B, Hq, T1, D); k_new/v_new: (B, Hkv, T1, D), NOT yet appended.
    Returns (B, Hq, T1, D) f32.  pad_len masks history positions below
    each row's left pad; the causal diagonal is exempt inside the
    predicate, so a fully padded row keeps a finite softmax.

    The JAX package computes this with plain einsums and no Pallas
    kernel; so does the port, on the CPU and the card alike.  A host-int
    length reads only the live history [0, length): the masked positions
    past it contribute exact zeros in the JAX version.  A per-row device
    length (B,) (the speculative batcher's verify over slot caches) reads
    the whole store, each row masked past its own length, with no host
    read."""
    B, Hq, T1, D = q.shape
    Hkv = cache.k.shape[1]
    r = Hq // Hkv
    dev = q.device
    per_row = isinstance(cache.length, torch.Tensor)
    Th = cache.max_seq_len if per_row else cache.length
    T0 = (cache.length.to(device=dev, dtype=torch.int64).reshape(
        B, 1, 1, 1, 1) if per_row else cache.length)
    qg = q.reshape(B, Hkv, r, T1, D).float()

    att_h = torch.einsum("bhrqd,bhdt->bhrqt", qg, cache.k[..., :Th].float())
    pos = torch.arange(Th, device=dev)
    if per_row:
        att_h = att_h.masked_fill(pos >= T0, NEG_INF)
    att_s = torch.einsum("bhrqd,bhjd->bhrqj", qg, k_new.float())
    qi = torch.arange(T1, device=dev)[:, None]
    kj = torch.arange(T1, device=dev)[None, :]
    att_s = att_s.masked_fill(kj > qi, NEG_INF)

    if sliding_window:
        lo = (T0 + torch.arange(T1, device=dev).reshape(1, 1, 1, T1, 1)
              - (sliding_window - 1))
        att_h = att_h.masked_fill(pos < lo, NEG_INF)
        att_s = att_s.masked_fill(kj + T0 < lo, NEG_INF)

    if pad_len is not None:
        pad = pad_len.to(device=dev, dtype=torch.int64).reshape(B, 1, 1, 1,
                                                                1)
        att_h = att_h.masked_fill(pos < pad, NEG_INF)
        keep = (kj + T0 >= pad) | (kj == qi)
        att_s = att_s.masked_fill(~keep, NEG_INF)

    att = torch.cat([att_h, att_s], dim=-1) / math.sqrt(D)
    p = torch.softmax(att, dim=-1)
    out = torch.einsum("bhrqt,bhtd->bhrqd", p[..., :Th],
                       cache.v[:, :, :Th].float())
    out = out + torch.einsum("bhrqj,bhjd->bhrqd", p[..., Th:],
                             v_new.float())
    return out.reshape(B, Hq, T1, D)


def fp_decode_attention(q, cache: FpLayerCache,
                        sliding_window: Optional[int] = None,
                        pad_len: Optional[torch.Tensor] = None,
                        fill_bound: Optional[int] = None
                        ) -> torch.Tensor:
    """Exact single-token decode attention over the fp cache.

    q: (B, Hq, 1, D) -> (B, Hq, 1, D) f32.  CUDA tensors go to the
    flash-decode kernel (kernels/fp_decode.py), with the host-int length
    or each row's length read on the device; CPU tensors go to its plain
    version.  pad_len: optional (B,) int left pad per row.  fill_bound:
    optional STATIC upper bound on every row's length, rounded as in
    core.attention.decode_attention and passed to the per-row kernel as
    its t_bound (host-int lengths size the grid themselves); checked
    under a checked call (kivi_tpu/cache/fp_cache.py:167-178)."""
    B, Hq, M, D = q.shape
    Hkv = cache.k.shape[1]
    r = Hq // Hkv
    tb = t_bound_for(fill_bound, cache.max_seq_len)
    if tb is not None and checking():
        n = cache.length
        if isinstance(n, torch.Tensor):
            n = n.max()
        debug_check(n <= tb, "fp_decode t_bound violated: length={n} "
                    "exceeds t_bound={tb}: attention would be silently "
                    "truncated", n=n, tb=tb)
    if not isinstance(cache.length, torch.Tensor):
        tb = None
    out = fp_decode_attention_kernel(
        q.reshape(B, Hkv, r, D).contiguous(), cache.k, cache.v,
        cache.length, sliding_window=sliding_window, pad_len=pad_len,
        t_bound=tb)
    return out.reshape(B, Hq, M, D)
