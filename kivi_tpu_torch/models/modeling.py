"""Decoder-only transformer (Llama-2/3, LongChat, Mistral) over the KIVI
or the fp16 cache: port of the main-path subset of
`kivi_tpu/models/modeling.py`.

Plain functions over a parameter dict.  Weights keep the JAX package's
(in, out) layout, so every projection is `x @ W`; layers are a list of
per-layer dicts (see models/convert.py for the JAX pytree).  Caches are a
list of per-layer `KiviLayerCache`s or `FpLayerCache`s, updated in
place.  Weights and activations are bf16 on the main path; norms and
attention softmax run in f32.

Modes: `prefill` (one-shot, through flash_attention), `extend` (chunked
prefill) and `decode`, over either cache.  Decode also runs over caches
whose counters are per-row device tensors (the continuous batcher's
slot caches, `init_slot_caches`; the engine's caches while it replays
its decode step): the masked, per-row appends, with `active=` selecting
the rows that advance, and attention reading the counters on the
device under an optional static `fill_bound`.  Under a checked call
(`utils.guards`, `Engine(debug=True)`) every layer's appended K/V and
the logits are checked finite.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache.fp_cache import (FpLayerCache, fp_append,
                                           fp_append_masked,
                                           fp_decode_attention,
                                           fp_extend_attention,
                                           init_fp_cache,
                                           init_fp_slot_cache)
from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.core.attention import (decode_attention,
                                           extend_attention,
                                           prefill_attention)
from kivi_tpu_torch.utils.guards import check_finite, checking, debug_check
# re-exported: entry points resolve their device here
from kivi_tpu_torch.utils.device import resolve_device  # noqa: F401


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 linear_scale: Optional[float] = None, *,
                 cfg: Optional[ModelConfig] = None):
    """positions (...,) int -> cos/sin (..., head_dim//2) f32 (HF
    half-split convention).  `linear_scale` divides positions (HF
    "linear"); a `cfg` with rope_scaling_kind == "llama3" applies the
    frequency-dependent Llama-3.1 scheme instead."""
    half = head_dim // 2
    dev = positions.device
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=dev) / half)
    pos = positions.float()
    if cfg is not None and cfg.rope_scaling is not None \
            and cfg.rope_scaling_kind == "llama3":
        factor = cfg.rope_scaling
        lo_f, hi_f = cfg.rope_low_freq_factor, cfg.rope_high_freq_factor
        orig = float(cfg.rope_original_max_position)
        wavelen = 2.0 * math.pi / inv_freq
        scaled = torch.where(wavelen > orig / lo_f, inv_freq / factor,
                             inv_freq)
        smooth = (orig / wavelen - lo_f) / (hi_f - lo_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        medium = (wavelen >= orig / hi_f) & (wavelen <= orig / lo_f)
        inv_freq = torch.where(medium, smoothed, scaled)
    elif linear_scale is not None:
        pos = pos / linear_scale
    ang = pos[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """HF rotate-half rope on halves: x1*cos - x2*sin || x2*cos + x1*sin,
    computed in f32 and cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    o1 = (x1 * cos - x2 * sin).to(x.dtype)
    o2 = (x2 * cos + x1 * sin).to(x.dtype)
    return torch.cat([o1, o2], dim=-1)


def swiglu_mlp(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


# ---------------------------------------------------------------------------
# one decoder layer
# ---------------------------------------------------------------------------

def _attention_block(x, lp, cache, cfg: ModelConfig, qcfg: QuantConfig,
                     positions, *, mode: str, flush: bool = True,
                     pad_len=None, prev_len: int = 0, active=None,
                     fill_bound: Optional[int] = None, layer: int = 0):
    """mode: 'prefill' (T tokens into an empty cache), 'extend' (T suffix
    tokens onto a cache holding prev_len tokens: chunked prefill) or
    'decode' (T == 1).  The cache is a KiviLayerCache or an
    FpLayerCache.  Decode over per-row device counters takes the masked
    appends: active (B,) bool selects the rows that advance (None: every
    row), and flush=False skips their window flushes (the engine runs
    them on its schedule).  fill_bound: decode only, a static bound on
    every row's fill (core.attention.decode_attention)."""
    B, T, _ = x.shape
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    fp = isinstance(cache, FpLayerCache)

    q = (x @ lp["wq"]).reshape(B, T, Hq, D).transpose(1, 2)
    k = (x @ lp["wk"]).reshape(B, T, Hkv, D).transpose(1, 2)
    v = (x @ lp["wv"]).reshape(B, T, Hkv, D).transpose(1, 2)

    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta, cfg.rope_scaling,
                            cfg=cfg)
    cos, sin = cos[:, None], sin[:, None]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if mode in ("prefill", "extend") and pad_len is not None:
        # Pad slots occupy real cache positions but must never leak:
        # attention masks them, and their stored K/V are zeroed so the K
        # quantization groups straddling the pad boundary see 0s (token i
        # sits at cache position prev_len + i; prev_len is 0 in prefill)
        cpos = prev_len + torch.arange(T, device=x.device)
        live = cpos[None, None, :, None] >= pad_len.reshape(B, 1, 1, 1)
        k = torch.where(live, k, torch.zeros_like(k))
        v = torch.where(live, v, torch.zeros_like(v))
    check_finite(k, f"layer {layer}: the keys appended to the cache")
    check_finite(v, f"layer {layer}: the values appended to the cache")

    if mode == "prefill":
        assert cache.seq_len == 0, "prefill needs an empty cache"
        out = prefill_attention(q, k, v, sliding_window=cfg.sliding_window,
                                pad_len=pad_len)
        if fp:
            fp_append(cache, k, v)
        else:
            KC.prefill_ingest(cache, k, v, qcfg)
    elif mode == "extend":
        # attention reads the PRE-extension cache
        if fp:
            out = fp_extend_attention(q, k, v, cache,
                                      sliding_window=cfg.sliding_window,
                                      pad_len=pad_len)
            fp_append(cache, k, v)
        else:
            out = extend_attention(q, k, v, cache, qcfg,
                                   sliding_window=cfg.sliding_window,
                                   pad_len=pad_len)
            KC.prefill_extend(cache, k, v, qcfg, prev_len)
    elif mode == "decode":
        per_row = isinstance(cache.seq_len, torch.Tensor)
        if fp:
            if per_row:
                fp_append_masked(cache, k, v, active)
            else:
                fp_append(cache, k, v)
            out = fp_decode_attention(q, cache,
                                      sliding_window=cfg.sliding_window,
                                      pad_len=pad_len,
                                      fill_bound=fill_bound)
        else:
            if per_row:
                # per-row windows on the device: masked slice writes,
                # each row flushing its own (the batcher) or none
                KC.decode_append_masked(cache, k, v, qcfg, active=active,
                                        do_flush=flush)
            else:
                KC.decode_append(cache, k, v, qcfg, do_flush=flush)
            out = decode_attention(q, cache, qcfg,
                                   sliding_window=cfg.sliding_window,
                                   pad_len=pad_len, fill_bound=fill_bound)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.transpose(1, 2).reshape(B, T, Hq * D).to(x.dtype)
    return out @ lp["wo"]


def _decoder_layer(x, lp, cache, cfg, qcfg, positions, *, mode, flush=True,
                   pad_len=None, prev_len=0, active=None, fill_bound=None,
                   layer=0):
    h = _attention_block(rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps), lp,
                         cache, cfg, qcfg, positions, mode=mode,
                         flush=flush, pad_len=pad_len, prev_len=prev_len,
                         active=active, fill_bound=fill_bound, layer=layer)
    x = x + h
    return x + swiglu_mlp(rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps),
                          lp["wg"], lp["wu"], lp["wd"])


# ---------------------------------------------------------------------------
# full model forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(params: dict, tokens: torch.Tensor, caches: List, cfg:
            ModelConfig, qcfg: QuantConfig, positions: torch.Tensor, *,
            mode: str, last_only: bool = False, flush: bool = True,
            pad_len: Optional[torch.Tensor] = None,
            prev_len: int = 0,
            active: Optional[torch.Tensor] = None,
            fill_bound: Optional[int] = None
            ) -> Tuple[torch.Tensor, List]:
    """tokens (B, T) int; positions (B, T) int RoPE positions (for
    left-padded rows: cache index minus pad_len, clamped at 0).  The
    caches are updated in place.

    active: (B,) bool, decode mode over per-row device counters
    (init_slot_caches): `decode_append_masked` / `fp_append_masked`,
    rows where it is false keep their counters
    (kivi_tpu/models/modeling.py:232-254); None advances every row.

    fill_bound: decode mode, an optional STATIC upper bound on every
    row's cache fill for this call (kivi_tpu/models/modeling.py:117,
    263-268), passed to the decode kernels as their grid bound.

    Returns (logits (B, T, vocab) f32, caches); with last_only the logits
    are (B, 1, vocab) for the final position."""
    x = params["embed"][tokens]
    for i, (lp, cache) in enumerate(zip(params["layers"], caches)):
        x = _decoder_layer(x, lp, cache, cfg, qcfg, positions, mode=mode,
                           flush=flush, pad_len=pad_len, prev_len=prev_len,
                           active=active, fill_bound=fill_bound, layer=i)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    logits = (x @ params["lm_head"]).float()
    check_finite(logits, "the logits")
    return logits, caches


def init_caches(cfg: ModelConfig, qcfg: QuantConfig, batch: int,
                max_seq_len: int, dtype=torch.bfloat16,
                device=None) -> List:
    """List of per-layer caches, each preallocated at max_seq_len: KIVI
    caches when qcfg.quantize_kv, else fp caches (the baseline)."""
    device = resolve_device(device)
    if not qcfg.quantize_kv:
        return [init_fp_cache(batch, cfg.num_kv_heads, cfg.head_dim,
                              max_seq_len, dtype, device)
                for _ in range(cfg.num_layers)]
    return [KC.init_layer_cache(batch, cfg.num_kv_heads, cfg.head_dim,
                                max_seq_len, qcfg, dtype, device)
            for _ in range(cfg.num_layers)]


def init_slot_caches(cfg: ModelConfig, qcfg: QuantConfig, num_slots: int,
                     max_seq_len: int, dtype=torch.bfloat16,
                     device=None) -> List:
    """`init_caches` for the continuous batcher: one row per slot, each
    layer's counters (num_slots,) int32 tensors on the device."""
    device = resolve_device(device)
    if not qcfg.quantize_kv:
        return [init_fp_slot_cache(num_slots, cfg.num_kv_heads,
                                   cfg.head_dim, max_seq_len, dtype, device)
                for _ in range(cfg.num_layers)]
    return [KC.init_slot_cache(num_slots, cfg.num_kv_heads, cfg.head_dim,
                               max_seq_len, qcfg, dtype, device)
            for _ in range(cfg.num_layers)]


def flush_caches(caches, qcfg: QuantConfig, k: bool = False,
                 v: bool = False):
    """Unconditional window flushes across all layers (the engine's
    statically scheduled decode path; see KC.flush_k_now/flush_v_now).
    Over per-row device counters: the masked flushes with no predicate,
    each row flushing its full window (KC.flush_k_masked /
    flush_v_masked), no counter read on the host; under a checked call
    every row's window must be full (the schedule matches the cache)."""
    W = qcfg.residual_length
    for i, c in enumerate(caches):
        per_row = isinstance(c.n_k_quant, torch.Tensor)
        if per_row and checking():
            full = ((c.n_k_win == W) | (not k)) & ((c.n_v_win == W) | (not v))
            debug_check(full.all(), "flush schedule violated: layer {i} "
                        "flushes a window that is not full", i=i)
        if k:
            (KC.flush_k_masked if per_row else KC.flush_k_now)(c, qcfg)
        if v:
            (KC.flush_v_masked if per_row else KC.flush_v_now)(c, qcfg)
    return caches


# ---------------------------------------------------------------------------
# random init (tests / benchmarks with realistic shapes)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random weights drawn from a torch.Generator on the target device
    (the same scales as the JAX package's init_params, not its bits)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    Hq, Hkv, D, Hd = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.hidden_size)
    I, V = cfg.intermediate_size, cfg.vocab_size

    def nrm(shape, scale):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    s = Hd ** -0.5
    layers = [{
        "ln_attn": ones(Hd), "ln_mlp": ones(Hd),
        "wq": nrm((Hd, Hq * D), s), "wk": nrm((Hd, Hkv * D), s),
        "wv": nrm((Hd, Hkv * D), s), "wo": nrm((Hq * D, Hd), s),
        "wg": nrm((Hd, I), s), "wu": nrm((Hd, I), s),
        "wd": nrm((I, Hd), I ** -0.5),
    } for _ in range(cfg.num_layers)]
    return {"embed": nrm((V, Hd), 1.0), "layers": layers,
            "ln_f": ones(Hd), "lm_head": nrm((Hd, V), s)}
