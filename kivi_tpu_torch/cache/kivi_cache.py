"""Static-shape KIVI KV cache in PyTorch: port of the main-path subset of
`kivi_tpu/cache/kivi_cache.py`.

Everything is preallocated at `max_seq_len` and updated IN PLACE: where
the JAX package donates buffers and returns new arrays, the port
`copy_`s into slices of the preallocated tensors.  Every function still
returns the cache (the same object) so call sites read like the JAX ones.

The four counters are host Python ints, uniform over the batch as in
the JAX cache.  The flush schedule is known on the host, so no step
needs a device-to-host sync to read them; they reach the kernels as
plain int arguments.  (Capturing the decode step in a CUDA graph will
need them on the device.)

Streaming policy (reference `models/llama_kivi.py:131-144, 174-187`):
  * every token appends post-RoPE K and V to fp windows;
  * a full K window (`residual_length` tokens) is quantized wholesale;
  * a full V window quantizes its oldest `v_flush` tokens and shifts;
  * the quantized-V count rounds to `v_flush` at ingest;
  * `prefill_extend` zero-fills and rewrites both windows.
"""

from __future__ import annotations

import dataclasses

import torch

from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels.quant_pack import quantize_pack_k, quantize_pack_v
from kivi_tpu_torch.utils.device import resolve_device


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
      n_*:     host ints - valid token counts (quant stores / windows)
    """

    k_codes: torch.Tensor
    k_scale: torch.Tensor
    k_mn: torch.Tensor
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    v_mn: torch.Tensor
    k_win: torch.Tensor
    v_win: torch.Tensor
    n_k_quant: int = 0
    n_k_win: int = 0
    n_v_quant: int = 0
    n_v_win: int = 0

    @property
    def seq_len(self) -> int:
        """Total tokens seen."""
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


# ---------------------------------------------------------------------------
# internal append helpers (token axis is LAST in all quant stores)
# ---------------------------------------------------------------------------

def _append_k_quant(cache: KiviLayerCache, k_block, qcfg: QuantConfig,
                    n_tokens: int) -> KiviLayerCache:
    """Quantize k_block (B,H,n_tokens,D) and write it at n_k_quant.
    Scales are cast to the store's scale dtype by the copy."""
    gs = qcfg.group_size
    codes, scale, mn = quantize_pack_k(k_block, gs, qcfg.k_bits)
    off = cache.n_k_quant
    goff = off // gs
    cache.k_codes[..., off:off + n_tokens].copy_(codes)
    cache.k_scale[:, :, goff:goff + n_tokens // gs].copy_(scale)
    cache.k_mn[:, :, goff:goff + n_tokens // gs].copy_(mn)
    cache.n_k_quant = off + n_tokens
    return cache


def _append_v_quant(cache: KiviLayerCache, v_block, qcfg: QuantConfig,
                    n_tokens: int) -> KiviLayerCache:
    """Quantize v_block (B,H,n_tokens,D) and write it at n_v_quant."""
    codes, scale, mn = quantize_pack_v(v_block, qcfg.group_size,
                                       qcfg.v_bits)
    off = cache.n_v_quant
    cache.v_codes[..., off:off + n_tokens].copy_(codes)
    cache.v_scale[..., off:off + n_tokens].copy_(scale)
    cache.v_mn[..., off:off + n_tokens].copy_(mn)
    cache.n_v_quant = off + n_tokens
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
