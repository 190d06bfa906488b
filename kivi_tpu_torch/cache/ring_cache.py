"""The bf16 ring of a sliding-window layer, beside the KIVI and fp caches.

A sliding layer attends its own position and the window - 1 before it,
so W = window slots a row hold all it ever reads: position p lives at
slot p % W.  The slots are preallocated and written in place, so a
replayed decode step (utils/graphs.py) updates the ring it was captured
over.  Keys are stored transposed, (B, H, D, W), and values (B, H, W, D),
the fp cache's layouts, so that decode runs row 9 (`fp_decode`) over the
slots: once RoPE has been applied the order of the positions does not
matter to attention, only which are held.

`length` counts the positions seen (not the ones held, min(length, W)),
in the two kinds of the other caches: a host int uniform over the batch
(the engine's prefill and extend), or a (B,) int32 device tensor per row
(the engine's replayed decode, `counters_to_device`).  It is the cache's
`seq_len`, as the KIVI layers' counts add up to theirs.

Prefill writes the prompt's last min(T, W) keys and values; extend
attends the held positions and the chunk (row 10's window test,
`kpos > qpos - W`) and writes the chunk's last ones; decode writes the
new token at slot length % W and attends every held slot.  Left pads and
the per-row extend are not supported: a ring slot does not know its pad.

`counters_to_device` / `counters_to_host` move the counters of a list of
caches that mixes rings with KIVI (or fp) caches, one copy and one read
as the KIVI cache's own do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache.fp_cache import FpLayerCache, fp_extend_attention
from kivi_tpu_torch.kernels.fp_decode import (NEG_INF,
                                               fp_decode_attention_kernel)
from kivi_tpu_torch.kernels.quant_pack import masked_store_write
from kivi_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class RingLayerCache:
    """k: (B, H, D, W) transposed keys; v: (B, H, W, D); length: the
    positions seen, a host int or (B,) int32 device tensor."""

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor] = 0

    @property
    def seq_len(self) -> Union[int, torch.Tensor]:
        return self.length

    @property
    def window(self) -> int:
        return self.k.shape[-1]


def init_ring_cache(batch: int, num_kv_heads: int, head_dim: int,
                    window: int, dtype=torch.bfloat16,
                    device=None) -> RingLayerCache:
    device = resolve_device(device)
    B, H, D, W = batch, num_kv_heads, head_dim, window
    return RingLayerCache(
        k=torch.zeros((B, H, D, W), dtype=dtype, device=device),
        v=torch.zeros((B, H, W, D), dtype=dtype, device=device))


def _write(cache: RingLayerCache, k_new, v_new, first: int) -> None:
    """Write the last min(T, W) of T tokens (B, H, T, D), the first of
    which sits at position `first`, into their slots (host ints)."""
    W, T = cache.window, k_new.shape[2]
    n = min(T, W)
    slots = torch.arange(first + T - n, first + T,
                         device=cache.k.device) % W
    cache.k.index_copy_(3, slots, k_new[:, :, T - n:].transpose(-1, -2)
                        .to(cache.k.dtype))
    cache.v.index_copy_(2, slots, v_new[:, :, T - n:].to(cache.v.dtype))


def ring_prefill(cache: RingLayerCache, k, v) -> RingLayerCache:
    """A whole prompt's post-RoPE K/V (B, H, T, D) into an empty ring."""
    assert cache.length == 0, "prefill needs an empty ring"
    _write(cache, k, v, 0)
    cache.length = k.shape[2]
    return cache


def ring_extend_attention(q, k_new, v_new, cache: RingLayerCache
                          ) -> torch.Tensor:
    """T1 queries (B, Hq, T1, D) at positions length .. length + T1 - 1
    over the held positions and the chunk itself, NOT yet appended: the
    window test `kpos > qpos - W` (host-int length).  The held positions
    are gathered in order and handed to the fp cache's extend attention,
    whose window test is the same up to a shift of every position.
    Returns (B, Hq, T1, D) f32."""
    n, W = cache.length, cache.window
    if isinstance(n, torch.Tensor):
        raise NotImplementedError("ring extend over per-row counters")
    h = min(n, W)
    slots = torch.arange(n - h, n, device=cache.k.device) % W
    held = FpLayerCache(k=cache.k.index_select(3, slots),
                        v=cache.v.index_select(2, slots), length=h)
    return fp_extend_attention(q, k_new, v_new, held, sliding_window=W)


def ring_append(cache: RingLayerCache, k_new, v_new) -> RingLayerCache:
    """T tokens (B, H, T, D) after the held ones (host-int length)."""
    _write(cache, k_new, v_new, cache.length)
    cache.length += k_new.shape[2]
    return cache


def ring_decode_append(cache: RingLayerCache, k_new, v_new
                       ) -> RingLayerCache:
    """One token (B, H, 1, D) at slot length % W of each row.  Per-row
    device lengths: slice-sized selected writes and an in-place count,
    no host read (the replayed decode step)."""
    W = cache.window
    if not isinstance(cache.length, torch.Tensor):
        s = cache.length % W
        cache.k[..., s].copy_(k_new[:, :, 0])
        cache.v[:, :, s].copy_(v_new[:, :, 0])
        cache.length += 1
        return cache
    slot = cache.length % W
    masked_store_write(cache.k, k_new.transpose(-1, -2), slot, 3)
    masked_store_write(cache.v, v_new, slot, 2)
    cache.length += 1
    return cache


def ring_decode_attention(q, cache: RingLayerCache) -> torch.Tensor:
    """One query (B, Hq, 1, D) per row over its held slots, the new
    token's included: (B, Hq, 1, D) f32.  CUDA tensors run row 9 over
    the slots with min(length, W) live; CPU tensors the plain version,
    which reads every slot under a mask and nothing back to the host."""
    B, Hq, _, D = q.shape
    Hkv, W = cache.k.shape[1], cache.window
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    n = cache.length
    held = (torch.clamp(n, max=W) if isinstance(n, torch.Tensor)
            else min(n, W))
    if q.is_cuda:
        out = fp_decode_attention_kernel(qg.contiguous(), cache.k, cache.v,
                                         held)
    else:
        out = ring_decode_attention_plain(qg, cache.k, cache.v, held)
    return out.reshape(B, Hq, 1, D)


def ring_decode_attention_plain(qg, k, v, held) -> torch.Tensor:
    """qg (B, H, r, D) over slots [0, held) of k (B, H, D, W) and
    v (B, H, W, D); held a host int or (B,) tensor.  f32."""
    B, H, r, D = qg.shape
    W = k.shape[-1]
    att = torch.einsum("bhrd,bhdw->bhrw", qg.float(), k.float()) / \
        math.sqrt(D)
    held = torch.as_tensor(held, device=qg.device).reshape(-1, 1, 1, 1)
    live = torch.arange(W, device=qg.device) < held
    p = torch.softmax(att.masked_fill(~live, NEG_INF), dim=-1)
    return torch.einsum("bhrw,bhwd->bhrd", p, v.float())


def _names(cache) -> tuple:
    return (KC._COUNTERS if isinstance(cache, KC.KiviLayerCache)
            else ("length",))


def counters_to_device(caches, buf: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """KC.counters_to_device over caches of mixed kinds: buf (L, 4, B)
    int32, a ring's (or an fp cache's) length in the first row of its
    layer."""
    first = getattr(caches[0], dataclasses.fields(caches[0])[0].name)
    B, dev = first.shape[0], first.device
    host = torch.zeros((len(caches), len(KC._COUNTERS), B),
                       dtype=torch.int32)
    for i, c in enumerate(caches):
        for j, n in enumerate(_names(c)):
            host[i, j] = getattr(c, n)
    if buf is None:
        buf = torch.empty(host.shape, dtype=torch.int32, device=dev)
    buf.copy_(host)
    for c, rows in zip(caches, buf):
        for n, row in zip(_names(c), rows):
            setattr(c, n, row)
    return buf


def counters_to_host(caches, buf: torch.Tensor) -> None:
    """The inverse of counters_to_device: one read of buf."""
    host = buf.cpu().tolist()
    for c, rows in zip(caches, host):
        for n, row in zip(_names(c), rows):
            if min(row) != max(row):
                raise RuntimeError(f"counter {n} differs across rows: "
                                   f"{row}")
            setattr(c, n, row[0])
