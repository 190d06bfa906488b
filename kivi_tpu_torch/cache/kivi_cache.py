"""Static-shape KIVI KV cache in PyTorch: port of the main-path subset of
`kivi_tpu/cache/kivi_cache.py`.

Everything is preallocated at `max_seq_len` and updated IN PLACE: where
the JAX package donates buffers and returns new arrays, the port
`copy_`s into slices of the preallocated tensors.  Every function still
returns the cache (the same object) so call sites read like the JAX ones.

The four counters come in two kinds:

  * host Python ints, uniform over the batch as in the JAX cache (the
    engine's prefill and its eager decode loop).  The flush schedule is
    known on the host, so no step needs a device-to-host sync to read
    them; they reach the kernels as plain int arguments;
  * (B,) int32 device tensors, one count per row (the continuous
    batcher's slot caches, `init_slot_cache`): the counterpart of the
    JAX batcher's `jax.vmap` over batch-1 caches.  They are updated by
    the masked, per-row functions (`decode_append_masked`,
    `flush_k_masked`, `flush_v_masked`) with no Python branch on a
    device value, and read per row by the decode kernel.  The engine
    moves its caches' counters to this form for a decode it replays as
    a CUDA graph and back after it (`counters_to_device`,
    `counters_to_host`): the counterpart of the JAX engine's traced
    counters under `lax.scan`.

Streaming policy (reference `models/llama_kivi.py:131-144, 174-187`):
  * every token appends post-RoPE K and V to fp windows;
  * a full K window (`residual_length` tokens) is quantized wholesale;
  * a full V window quantizes its oldest `v_flush` tokens and shifts;
  * the quantized-V count rounds to `v_flush` at ingest;
  * `prefill_extend` zero-fills and rewrites both windows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels.quant_pack import (masked_store_write,
                                               quantize_pack_k_into,
                                               quantize_pack_v_into)
from kivi_tpu_torch.utils.device import resolve_device
from kivi_tpu_torch.utils.guards import checking, debug_check


@dataclasses.dataclass
class KiviLayerCache:
    """Per-layer quantized KV state (layouts of the JAX cache).

      k_codes: int32 (B, H, KDw, T)   packed transposed keys
      k_scale: (B, H, T//gs, D)       one (D,) row per token group
      k_mn:    (B, H, T//gs, D)
      v_codes: int32 (B, H, VDw, T)   packed transposed values
      v_scale: (B, H, D//gs, T)       per (channel group, token)
      v_mn:    (B, H, D//gs, T)
      k_win:   (B, H, W, D) fp window of recent keys
      v_win:   (B, H, W, D) fp window of recent values
      n_*:     valid token counts (quant stores / windows): host ints,
               or (B,) int32 device tensors in a slot cache
    """

    k_codes: torch.Tensor
    k_scale: torch.Tensor
    k_mn: torch.Tensor
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    v_mn: torch.Tensor
    k_win: torch.Tensor
    v_win: torch.Tensor
    n_k_quant: Union[int, torch.Tensor] = 0
    n_k_win: Union[int, torch.Tensor] = 0
    n_v_quant: Union[int, torch.Tensor] = 0
    n_v_win: Union[int, torch.Tensor] = 0

    @property
    def seq_len(self) -> Union[int, torch.Tensor]:
        """Total tokens seen (per row in a slot cache)."""
        return self.n_k_quant + self.n_k_win

    @property
    def max_seq_len(self) -> int:
        return self.k_codes.shape[-1]


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def init_layer_cache(batch: int, num_kv_heads: int, head_dim: int,
                     max_seq_len: int, qcfg: QuantConfig,
                     dtype=torch.bfloat16, device=None) -> KiviLayerCache:
    """An empty cache preallocated at max_seq_len, on CUDA unless
    `device` says otherwise (utils.device.resolve_device)."""
    device = resolve_device(device)
    gs, W = qcfg.group_size, qcfg.residual_length
    assert max_seq_len % gs == 0
    assert head_dim % gs == 0, (
        f"group_size {gs} must divide head_dim {head_dim}")
    kdw = Q.num_words(head_dim, qcfg.k_bits)
    vdw = Q.num_words(head_dim, qcfg.v_bits)
    B, H, D, T = batch, num_kv_heads, head_dim, max_seq_len
    sdt = _DTYPES[qcfg.scale_dtype]

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return KiviLayerCache(
        k_codes=z((B, H, kdw, T), torch.int32),
        k_scale=z((B, H, T // gs, D), sdt),
        k_mn=z((B, H, T // gs, D), sdt),
        v_codes=z((B, H, vdw, T), torch.int32),
        v_scale=z((B, H, D // gs, T), sdt),
        v_mn=z((B, H, D // gs, T), sdt),
        k_win=z((B, H, W, D), dtype),
        v_win=z((B, H, W, D), dtype),
    )


_COUNTERS = ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win")


def init_slot_cache(num_slots: int, num_kv_heads: int, head_dim: int,
                    max_seq_len: int, qcfg: QuantConfig,
                    dtype=torch.bfloat16, device=None) -> KiviLayerCache:
    """An empty slot cache: `init_layer_cache` with one row per slot and
    its four counters as (num_slots,) int32 tensors on the device."""
    cache = init_layer_cache(num_slots, num_kv_heads, head_dim, max_seq_len,
                             qcfg, dtype, device)
    for f in _COUNTERS:
        setattr(cache, f, torch.zeros(num_slots, dtype=torch.int32,
                                      device=cache.k_codes.device))
    return cache



def counters_to_device(caches, buf: Optional[torch.Tensor] = None,
                       names=_COUNTERS) -> torch.Tensor:
    """Move the host-int counters `names` of a list of caches (one batch
    size, uniform over the batch) onto the device in one copy: into
    buf (L, len(names), B) int32 (allocated when None), whose rows then
    serve as the caches' (B,) counters.  Returns buf.  A decode step
    captured over these counters reads the same storage on every
    replay."""
    # every tensor field has the row axis first (see write_slot)
    first = getattr(caches[0], dataclasses.fields(caches[0])[0].name)
    B, dev = first.shape[0], first.device
    host = torch.tensor([[[getattr(c, n)] * B for n in names]
                         for c in caches], dtype=torch.int32)
    if buf is None:
        buf = torch.empty(host.shape, dtype=torch.int32, device=dev)
    buf.copy_(host)
    for c, rows in zip(caches, buf):
        for n, row in zip(names, rows):
            setattr(c, n, row)
    return buf


def counters_to_host(caches, buf: torch.Tensor, names=_COUNTERS) -> None:
    """The inverse of counters_to_device after a uniform decode: one read
    of buf, each counter back to a host int.  Raises if the rows of a
    counter disagree (the engine's decode advances every row alike)."""
    host = buf.cpu().tolist()
    for c, rows in zip(caches, host):
        for n, row in zip(names, rows):
            if min(row) != max(row):
                raise RuntimeError(f"counter {n} differs across rows: "
                                   f"{row}")
            setattr(c, n, row[0])


def clear(cache):
    """Empty a host-int cache in place: every tensor zeroed, every counter
    0 (the state init_layer_cache / init_fp_cache return).  Works on
    KiviLayerCache and FpLayerCache alike."""
    for f in dataclasses.fields(cache):
        x = getattr(cache, f.name)
        if isinstance(x, torch.Tensor):
            x.zero_()
        else:
            setattr(cache, f.name, 0)
    return cache


def broadcast_rows(cache, batch: int):
    """Tile a batch-1 cache to `batch` rows as new tensors (the prefix
    fan-out, kivi_tpu/cache/kivi_cache.py:274-284); batch 1 is a copy.
    Works on KiviLayerCache and FpLayerCache alike (every tensor field
    has the row axis first).  Host-int counters are copied as ints,
    device counters repeated: nothing of the result shares storage with
    the source, which a caller may then write in place."""
    return type(cache)(**{
        f.name: (x.expand(batch, *x.shape[1:]).clone()
                 if isinstance(x, torch.Tensor) else int(x))
        for f in dataclasses.fields(cache)
        for x in (getattr(cache, f.name),)})


def broadcast_rows_into(dst, src):
    """broadcast_rows written into an existing cache of B rows: every row
    of each tensor of dst becomes src's one row (copy_), and dst takes
    src's host-int counters.  dst's tensors keep their addresses (the
    engine's captured decode steps read them).  Raises ValueError when
    src was built for another cache length, dtype or geometry."""
    for f in dataclasses.fields(dst):
        d, s = getattr(dst, f.name), getattr(src, f.name)
        if not isinstance(d, torch.Tensor):
            setattr(dst, f.name, int(s))
            continue
        if s.shape[0] != 1 or s.shape[1:] != d.shape[1:] or \
                s.dtype != d.dtype:
            raise ValueError(
                f"{f.name}: a snapshot of {tuple(s.shape)} {s.dtype} does "
                f"not fit a cache of {tuple(d.shape)} {d.dtype} (build the "
                "snapshot with the same config, cache length and dtype)")
        d.copy_(s.expand_as(d))
    return dst


def reorder(cache, idx: torch.Tensor):
    """Select or permute batch rows (the beam-search reorder,
    kivi_tpu/cache/kivi_cache.py:525-538): a new cache whose row b is
    row idx[b] of every tensor, device counters included; host-int
    counters (uniform over the batch) carry over."""
    return type(cache)(**{
        f.name: (x.index_select(0, idx) if isinstance(x, torch.Tensor)
                 else x)
        for f in dataclasses.fields(cache)
        for x in (getattr(cache, f.name),)})


# the token axis of each store that grows with the sequence (KIVI and fp
# caches); the windows and counters have none
_TOKEN_AXIS = {"k_codes": 3, "k_scale": 2, "k_mn": 2, "v_codes": 3,
               "v_scale": 3, "v_mn": 3, "k": 3, "v": 2}


def reorder_into(cache, idx: torch.Tensor, bound: Optional[int] = None):
    """reorder in place: every tensor of the cache keeps its address (the
    body of a captured beam step).  bound: gather the stores only below
    this token position (the windows and counters whole).  Exact when
    every row holds the same bytes at and past the bound, as rows fanned
    out from one snapshot or prefilled into a cleared cache do while
    their fill stays below it; the JAX package gathers every buffer at
    full length."""
    T = cache.max_seq_len
    for f in dataclasses.fields(cache):
        x = getattr(cache, f.name)
        if not isinstance(x, torch.Tensor):
            continue
        ax = _TOKEN_AXIS.get(f.name)
        if bound is not None and ax is not None and bound < T:
            x = x.narrow(ax, 0, -(-x.shape[ax] * bound // T))
        x.copy_(x.index_select(0, idx))
    return cache


def write_slot(slot_cache, s: int, one_cache):
    """Copy a batch-1 host-int cache (an admission prefill's output) into
    row s of a slot cache and set the row's counters: the counterpart of
    the JAX batcher's `dynamic_update_index_in_dim` at the slot.  Works on
    KiviLayerCache and FpLayerCache alike (every tensor field has the row
    axis first; every host-int field is a counter)."""
    for f in dataclasses.fields(slot_cache):
        dst, src = getattr(slot_cache, f.name), getattr(one_cache, f.name)
        if isinstance(src, torch.Tensor):
            dst[s].copy_(src[0])
        else:
            dst[s] = src
    return slot_cache


# ---------------------------------------------------------------------------
# internal append helpers (token axis is LAST in all quant stores)
# ---------------------------------------------------------------------------

def _append_k_quant(cache: KiviLayerCache, k_block, qcfg: QuantConfig,
                    n_tokens: int) -> KiviLayerCache:
    """Quantize k_block (B,H,n_tokens,D) straight into the stores at
    n_k_quant (scales in the store's scale dtype)."""
    quantize_pack_k_into(k_block, qcfg.group_size, qcfg.k_bits,
                         cache.k_codes, cache.k_scale, cache.k_mn,
                         cache.n_k_quant)
    cache.n_k_quant += n_tokens
    return cache


def _append_v_quant(cache: KiviLayerCache, v_block, qcfg: QuantConfig,
                    n_tokens: int) -> KiviLayerCache:
    """Quantize v_block (B,H,n_tokens,D) straight into the stores at
    n_v_quant."""
    quantize_pack_v_into(v_block, qcfg.group_size, qcfg.v_bits,
                         cache.v_codes, cache.v_scale, cache.v_mn,
                         cache.n_v_quant)
    cache.n_v_quant += n_tokens
    return cache


def nvq_canonical(T: int, W: int, vf: int) -> int:
    """Quantized-value count at T tokens (rounded up to v_flush), in the
    prefill, extend and decode canonical states alike."""
    return 0 if T <= W else ((T - W + vf - 1) // vf) * vf


# ---------------------------------------------------------------------------
# prefill ingest (reference `models/llama_kivi.py:420-452`)
# ---------------------------------------------------------------------------

def prefill_ingest(cache: KiviLayerCache, k, v,
                   qcfg: QuantConfig) -> KiviLayerCache:
    """Ingest a whole prompt's post-RoPE K/V (B, H, T, D) into an empty
    cache.  Keys: quantize floor(T/W)*W tokens, the window keeps T mod W.
    Values: quantize the first max(0, T-W) tokens rounded up to v_flush,
    the window keeps the rest."""
    W = qcfg.residual_length
    T = k.shape[-2]
    nkq = (T // W) * W
    if nkq:
        _append_k_quant(cache, k[:, :, :nkq], qcfg, nkq)
    nkw = T - nkq
    if nkw:
        cache.k_win[:, :, :nkw].copy_(k[:, :, nkq:])
        cache.n_k_win = nkw

    nvq = nvq_canonical(T, W, qcfg.value_flush)
    if nvq:
        _append_v_quant(cache, v[:, :, :nvq], qcfg, nvq)
    nvw = T - nvq
    if nvw:
        cache.v_win[:, :, :nvw].copy_(v[:, :, nvq:])
        cache.n_v_win = nvw
    return cache


def prefill_extend(cache: KiviLayerCache, k, v, qcfg: QuantConfig,
                   prev_len: int) -> KiviLayerCache:
    """Continue prefill: ingest a suffix's post-RoPE K/V (B, H, T1, D)
    into a cache holding `prev_len` tokens (from prefill_ingest or
    prefill_extend).  The end state equals prefill_ingest of the whole
    prev_len + T1 prompt: quantization blocks depend only on absolute
    token position, so re-quantizing window tokens together with the
    suffix gives the codes the one-shot path would."""
    W = qcfg.residual_length
    vf = qcfg.value_flush
    T1 = k.shape[-2]
    T0, T = prev_len, prev_len + T1
    assert T0 == cache.seq_len, (T0, cache.seq_len)
    assert T <= cache.max_seq_len

    # ---- keys: quantize in W-blocks spanning old window + suffix ----
    wk0 = T0 % W
    tail_k = (torch.cat([cache.k_win[:, :, :wk0].to(k.dtype), k], dim=-2)
              if wk0 else k)
    nq_new = ((wk0 + T1) // W) * W
    if nq_new:
        _append_k_quant(cache, tail_k[:, :, :nq_new], qcfg, nq_new)
    wk1 = wk0 + T1 - nq_new
    cache.k_win.zero_()
    if wk1:
        cache.k_win[:, :, :wk1].copy_(tail_k[:, :, nq_new:])
    cache.n_k_win = wk1

    # ---- values: vf-aligned quantized count, as in prefill_ingest ----
    nvq0 = nvq_canonical(T0, W, vf)
    nvw0 = T0 - nvq0
    tail_v = (torch.cat([cache.v_win[:, :, :nvw0].to(v.dtype), v], dim=-2)
              if nvw0 else v)
    dq = nvq_canonical(T, W, vf) - nvq0
    if dq:
        _append_v_quant(cache, tail_v[:, :, :dq], qcfg, dq)
    nvw1 = T - cache.n_v_quant
    cache.v_win.zero_()
    if nvw1:
        cache.v_win[:, :, :nvw1].copy_(tail_v[:, :, dq:])
    cache.n_v_win = nvw1
    return cache


# ---------------------------------------------------------------------------
# decode append (reference `models/llama_kivi.py:333-399` state machine)
# ---------------------------------------------------------------------------

def flush_k_now(cache: KiviLayerCache, qcfg: QuantConfig) -> KiviLayerCache:
    """Quantize the (full) key window into the store.  The caller knows
    n_k_win == residual_length (the engine's flush schedule)."""
    assert cache.n_k_win == qcfg.residual_length, cache.n_k_win
    _append_k_quant(cache, cache.k_win, qcfg, qcfg.residual_length)
    cache.n_k_win = 0
    return cache


def flush_v_now(cache: KiviLayerCache, qcfg: QuantConfig) -> KiviLayerCache:
    """Quantize the oldest v_flush value-window tokens and shift the
    window.  The caller knows n_v_win == residual_length."""
    assert cache.n_v_win == qcfg.residual_length, cache.n_v_win
    vf = qcfg.value_flush
    _append_v_quant(cache, cache.v_win[:, :, :vf], qcfg, vf)
    W = cache.v_win.shape[2]
    # overlapping ranges: shift through a copy
    cache.v_win[:, :, :W - vf].copy_(cache.v_win[:, :, vf:].clone())
    cache.v_win[:, :, W - vf:].zero_()
    cache.n_v_win -= vf
    return cache


def decode_append(cache: KiviLayerCache, k_new, v_new, qcfg: QuantConfig,
                  do_flush: bool = True) -> KiviLayerCache:
    """Append one token's post-RoPE K/V (B, H, 1, D), flushing full
    windows first.  do_flush=False skips the flush checks, for callers
    that run the flushes on a static schedule (the engine's decode
    loop)."""
    W = qcfg.residual_length
    if do_flush:
        if cache.n_k_win == W:
            flush_k_now(cache, qcfg)
        if cache.n_v_win == W:
            flush_v_now(cache, qcfg)
    assert cache.n_k_win < W and cache.n_v_win < W, (
        "window full: a scheduled flush was skipped")
    cache.k_win[:, :, cache.n_k_win].copy_(k_new[:, :, 0])
    cache.v_win[:, :, cache.n_v_win].copy_(v_new[:, :, 0])
    cache.n_k_win += 1
    cache.n_v_win += 1
    return cache


# ---------------------------------------------------------------------------
# masked, per-row updates of a slot cache (kivi_tpu/cache/kivi_cache.py:
# 348-401, 457-522): the continuous batcher's decode step.  The flushes
# quantize straight into the stores on the rows that flush (the kernel's
# other rows load nothing); the window appends are slice-sized selected
# writes (kernels.quant_pack.masked_store_write)
# ---------------------------------------------------------------------------

def _row_pred(cache: KiviLayerCache, pred) -> torch.Tensor:
    B = cache.k_win.shape[0]
    if pred is None:
        return torch.ones(B, dtype=torch.bool, device=cache.k_win.device)
    return pred.to(device=cache.k_win.device, dtype=torch.bool).reshape(B)


def flush_k_masked(cache: KiviLayerCache, qcfg: QuantConfig,
                   pred: Optional[torch.Tensor] = None) -> KiviLayerCache:
    """Masked key-window flush of a slot cache: quantize the window
    straight into the stores at each row's n_k_quant (clamped, as XLA's
    dynamic_update_slice) on rows where pred & (n_k_win == W), never a
    branch on the counters.  The other rows' stores are not touched."""
    W, gs = qcfg.residual_length, qcfg.group_size
    flush_k = _row_pred(cache, pred) & (cache.n_k_win == W)
    quantize_pack_k_into(cache.k_win, gs, qcfg.k_bits, cache.k_codes,
                         cache.k_scale, cache.k_mn, cache.n_k_quant, flush_k)
    cache.n_k_quant += flush_k.to(torch.int32) * W
    cache.n_k_win.masked_fill_(flush_k, 0)
    return cache


def flush_v_masked(cache: KiviLayerCache, qcfg: QuantConfig,
                   pred: Optional[torch.Tensor] = None) -> KiviLayerCache:
    """Masked value-window flush (the oldest v_flush tokens, then the
    window shifts) on rows where pred & (n_v_win == W); see
    flush_k_masked.  The shift is a torch select over every row."""
    W, vf, gs = qcfg.residual_length, qcfg.value_flush, qcfg.group_size
    flush_v = _row_pred(cache, pred) & (cache.n_v_win == W)
    quantize_pack_v_into(cache.v_win[:, :, :vf], gs, qcfg.v_bits,
                         cache.v_codes, cache.v_scale, cache.v_mn,
                         cache.n_v_quant, flush_v)
    shifted = torch.cat([cache.v_win[:, :, vf:],
                         torch.zeros_like(cache.v_win[:, :, :vf])], dim=2)
    cache.v_win.copy_(torch.where(flush_v.reshape(-1, 1, 1, 1), shifted,
                                  cache.v_win))
    step = flush_v.to(torch.int32) * vf
    cache.n_v_quant += step
    cache.n_v_win -= step
    return cache


def decode_append_masked(cache: KiviLayerCache, k_new, v_new,
                         qcfg: QuantConfig,
                         active: Optional[torch.Tensor] = None,
                         do_flush: bool = True) -> KiviLayerCache:
    """`decode_append` for a cache with per-row device counters whose
    rows may sit at divergent window phases: each row flushes its own
    full windows, then appends one token's K/V (B, H, 1, D).  Rows where
    active (B,) is false freeze every counter, and their window writes
    carry the window's own bytes: an inactive row may sit at n_win == W,
    where the clamped write lands on the last REAL window token.  Only
    rows that flush quantize their window and write their stores (the
    JAX package quantizes every row's window every step and writes the
    others' bytes back); the quantizer still launches every step, and
    its blocks of the other rows return before loading anything.

    active None: every row advances.  do_flush=False skips the flushes,
    for a caller that runs them on a static schedule (the engine's
    replayed decode step): the step is then the two window writes and
    the counter increments."""
    act = None if active is None else _row_pred(cache, active)
    if do_flush:
        flush_k_masked(cache, qcfg, act)
        flush_v_masked(cache, qcfg, act)
    elif checking():
        W = qcfg.residual_length
        room = (cache.n_k_win < W) & (cache.n_v_win < W)
        debug_check((room if act is None else room | ~act).all(),
                    "window full: a scheduled flush was skipped")
    masked_store_write(cache.k_win, k_new, cache.n_k_win, 2, act)
    masked_store_write(cache.v_win, v_new, cache.n_v_win, 2, act)
    inc = 1 if act is None else act.to(torch.int32)
    cache.n_k_win += inc
    cache.n_v_win += inc
    return cache


# ---------------------------------------------------------------------------
# window-only ingest and counter rollback (kivi_tpu/cache/kivi_cache.py:
# 404-455): the speculative decoders' ingest.  A speculation block never
# crosses a flush boundary (the decoders clamp its width to the next one),
# so rejecting its tail is a pure counter rollback
# ---------------------------------------------------------------------------

def _append_capped(win: torch.Tensor, new: torch.Tensor, n, act):
    """Write new (B, H, T1, D) into the window win (B, H, W, D) at each
    row's count n, dropping the tokens past W: the window's last row is
    never overwritten (a clamped write at n == W would land on the
    newest real token, which the next flush would quantize for good).
    Host-int n: a slice copy, returns the new count.  Device n (B,): a
    gather-select-scatter over the min(T1, W) slots from
    clamp(n, 0, W - min(T1, W)), whose tokens outside [n, n + T1) or on
    rows where act is false keep the window's own bytes; n is advanced
    in place.  Traffic O(T1) per row; no host read."""
    B, H, W, D = win.shape
    T1 = new.shape[2]
    if not isinstance(n, torch.Tensor):
        m = max(0, min(T1, W - n))
        if m:
            win[:, :, n:n + m].copy_(new[:, :, :m])
        return n + m
    L = min(T1, W)
    n64 = n.to(torch.int64)
    p = n64.clamp(0, W - L)[:, None] + torch.arange(L, device=win.device)
    j = p - n64[:, None]                       # token index at slot p
    sel = (j >= 0) & (j < T1)
    if act is not None:
        sel = sel & act[:, None]
    shape = (B, 1, L, 1)
    idx = p.reshape(shape).expand(B, H, L, D)
    src = new.gather(2, j.clamp(0, T1 - 1).reshape(shape).expand(
        B, H, L, D)).to(win.dtype)
    win.scatter_(2, idx, torch.where(sel.reshape(shape), src,
                                     win.gather(2, idx)))
    inc = (W - n).clamp(0, T1)
    n += inc if act is None else inc * act.to(n.dtype)
    return n


def window_append_capped(cache: KiviLayerCache, k_new, v_new,
                         active: Optional[torch.Tensor] = None
                         ) -> KiviLayerCache:
    """Append T1 tokens' post-RoPE K/V (B, H, T1, D) to the fp windows
    ONLY: no flush, no quantization, no quantized watermark moved.
    Tokens that would overflow a window are dropped, never written over
    its last row (kivi_tpu/cache/kivi_cache.py:404-440).  Dropped or
    stale rows sit past the valid counts, invisible to attention and
    overwritten by later appends before any flush can see them.

    Host-int counters (uniform over the batch): slice copies, active
    must be None.  Per-row device counters: each row at its own count,
    rows where active (B,) is false frozen (their writes carry the
    window's own bytes); every tensor keeps its storage and nothing is
    read back, so the call can be captured in a CUDA graph."""
    per_row = isinstance(cache.n_k_win, torch.Tensor)
    if active is not None and not per_row:
        raise ValueError("active= needs per-row device counters")
    act = None if active is None else _row_pred(cache, active)
    cache.n_k_win = _append_capped(cache.k_win, k_new, cache.n_k_win, act)
    cache.n_v_win = _append_capped(cache.v_win, v_new, cache.n_v_win, act)
    return cache


def rollback_counters(cache: KiviLayerCache, n_tokens,
                      active: Optional[torch.Tensor] = None
                      ) -> KiviLayerCache:
    """Roll the window counters back so that the cache holds exactly
    n_tokens committed tokens (kivi_tpu/cache/kivi_cache.py:443-455).
    Valid only while no quantized watermark moved past n_tokens, which
    the window-only ingest guarantees; the stale window rows beyond the
    new counts are invisible to attention.  Host-int counters take an
    int; per-row device counters an int or a (B,) tensor, written in
    place (rows where active is false keep theirs)."""
    if not isinstance(cache.n_k_win, torch.Tensor):
        n = int(n_tokens)
        cache.n_k_win = n - cache.n_k_quant
        cache.n_v_win = n - cache.n_v_quant
        return cache
    act = None if active is None else _row_pred(cache, active)
    for win, quant in ((cache.n_k_win, cache.n_k_quant),
                       (cache.n_v_win, cache.n_v_quant)):
        new = n_tokens - quant
        win.copy_(new if act is None else torch.where(act, new, win))
    return cache
