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
device under an optional static `fill_bound`.  `ingest="window"` (the
speculative decoders' ingest) appends to the fp windows only, in
decode and extend modes, so that a rejected block is a counter
rollback.  Under a checked call
(`utils.guards`, `Engine(debug=True)`) every layer's appended K/V and
the logits are checked finite.

An `ExaoneMoEConfig` (the K-EXAONE block) takes its own layer
(`_hybrid_forward`): QK-norm, RoPE on the sliding layers only, post-norms
after attention and MLP; a sliding layer's keys and values live in a
bf16 ring of `sliding_window` slots (cache/ring_cache.py), a full
layer's in the KIVI (or fp) cache with no window; the MLP of the first
`first_k_dense` layers is dense, every later one the expert layer
(`moe_mlp`: the router over every expert, the held experts' part of the
result through kernels/moe_grouped.py, the shared experts).  A plain
ModelConfig never reaches that code.  Pads, frozen rows, the
window-only ingest, `tp=` and `seq_group=` raise over its rings.

Parallel tier (parallel/): `tp=` is the tensor-parallel process group
of a (data, model) mesh.  The params and `cfg` are then one rank's
slice (`parallel.mesh.shard_params`, `local_config`), and the model
calls the collectives XLA inserts for the JAX package: an all-reduce
after the attention's output projection and after the MLP's down
projection, and an all-gather of the vocab-split logits.  `seq_group=`
(prefill only) is a sequence-parallel layout (`parallel.ring.SeqGroup`):
the tokens are this rank's block, attention runs as a ring, and K/V are
gathered back to the whole prompt before the cache ingest
(kivi_tpu/models/modeling.py:150-190).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache import ring_cache as RC
from kivi_tpu_torch.cache.fp_cache import (FpLayerCache, fp_append,
                                           fp_append_masked,
                                           fp_decode_attention,
                                           fp_extend_attention,
                                           init_fp_cache,
                                           init_fp_slot_cache)
from kivi_tpu_torch.config import ExaoneMoEConfig, ModelConfig, QuantConfig
from kivi_tpu_torch.core.attention import (decode_attention,
                                           extend_attention,
                                           prefill_attention)
from kivi_tpu_torch.kernels import moe_grouped
from kivi_tpu_torch.utils.collectives import all_gather_last, all_reduce_
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
                     fill_bound: Optional[int] = None, layer: int = 0,
                     ingest: str = "quant", tp=None, seq_group=None,
                     shared: int = 0):
    """mode: 'prefill' (T tokens into an empty cache), 'extend' (T suffix
    tokens onto a cache holding prev_len tokens: chunked prefill) or
    'decode' (T == 1).  The cache is a KiviLayerCache or an
    FpLayerCache.  Decode over per-row device counters takes the masked
    appends: active (B,) bool selects the rows that advance (None: every
    row), and flush=False skips their window flushes (the engine runs
    them on its schedule).  fill_bound: decode only, a static bound on
    every row's fill; shared: decode over the KIVI cache only, a static
    count of leading quantized positions bit-equal in every row
    (core.attention.decode_attention).

    ingest: "quant" runs the cache's own ingest (prefill_extend /
    decode_append, which may quantize a full window); "window" appends
    to the fp windows only (KC.window_append_capped: no flush, no
    quantized watermark moved, tokens past a full window dropped), in
    extend and decode modes (kivi_tpu/models/modeling.py:112-130).  Over
    per-row device counters, active (B,) then freezes rows in extend
    mode too; the fp cache appends as in decode.

    tp: the tensor-parallel group (None: no collective); seq_group: a
    sequence-parallel prefill's layout (forward's docstring)."""
    if ingest not in ("quant", "window"):
        raise ValueError(f"unknown ingest {ingest!r}")
    window = ingest == "window"
    B, T, _ = x.shape
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = (x @ lp["wq"]).reshape(B, T, Hq, D).transpose(1, 2)
    k = (x @ lp["wk"]).reshape(B, T, Hkv, D).transpose(1, 2)
    v = (x @ lp["wv"]).reshape(B, T, Hkv, D).transpose(1, 2)

    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta, cfg.rope_scaling,
                            cfg=cfg)
    cos, sin = cos[:, None], sin[:, None]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if mode in ("prefill", "extend") and pad_len is not None and not window:
        # Pad slots occupy real cache positions but must never leak:
        # attention masks them, and their stored K/V are zeroed so the K
        # quantization groups straddling the pad boundary see 0s (token i
        # sits at cache position prev_len + i; prev_len is 0 in prefill;
        # under a sequence-parallel layout slot s holds its true position)
        cpos = (prev_len + torch.arange(T, device=x.device)
                if seq_group is None else seq_group.positions)
        live = cpos[None, None, :, None] >= pad_len.reshape(B, 1, 1, 1)
        k = torch.where(live, k, torch.zeros_like(k))
        v = torch.where(live, v, torch.zeros_like(v))
    check_finite(k, f"layer {layer}: the keys appended to the cache")
    check_finite(v, f"layer {layer}: the values appended to the cache")
    out = _cache_attention(q, k, v, cache, qcfg, cfg.sliding_window,
                           mode=mode, flush=flush, pad_len=pad_len,
                           prev_len=prev_len, active=active,
                           fill_bound=fill_bound, ingest=ingest,
                           seq_group=seq_group, shared=shared)
    out = out.transpose(1, 2).reshape(B, T, Hq * D).to(x.dtype)
    return all_reduce_(out @ lp["wo"], tp)


def _cache_attention(q, k, v, cache, qcfg: QuantConfig,
                     sliding_window: Optional[int], *, mode: str,
                     flush: bool = True, pad_len=None, prev_len: int = 0,
                     active=None, fill_bound: Optional[int] = None,
                     ingest: str = "quant", seq_group=None,
                     shared: int = 0):
    """The attention of `_attention_block` over its cache, and the cache's
    ingest, from the post-RoPE q (B, Hq, T, D), k and v (B, Hkv, T, D):
    (B, Hq, T, D).  The arguments are `_attention_block`'s."""
    window = ingest == "window"
    fp = isinstance(cache, FpLayerCache)
    if mode == "prefill":
        assert cache.seq_len == 0, "prefill needs an empty cache"
        if seq_group is None:
            out = prefill_attention(q, k, v,
                                    sliding_window=sliding_window,
                                    pad_len=pad_len)
        else:
            from kivi_tpu_torch.parallel.ring import ring_attention
            out = ring_attention(q, k, v, seq_group.group,
                                 sliding_window=sliding_window,
                                 pad_len=pad_len,
                                 positions=seq_group.positions)
            # the ingest wants whole quantization groups in token order:
            # gather the token axis back (O(T) bytes; the ring split the
            # O(T^2) attention)
            k = seq_group.gather_tokens(k)
            v = seq_group.gather_tokens(v)
        if fp:
            fp_append(cache, k, v)
        else:
            KC.prefill_ingest(cache, k, v, qcfg)
    elif mode == "extend":
        # attention reads the PRE-extension cache; only the window-only
        # ingest can freeze rows (kivi_tpu/models/modeling.py:205)
        assert active is None or window, "extend active= needs window ingest"
        if fp:
            out = fp_extend_attention(q, k, v, cache,
                                      sliding_window=sliding_window,
                                      pad_len=pad_len)
            fp_append_masked(cache, k, v, active)
        else:
            out = extend_attention(q, k, v, cache, qcfg,
                                   sliding_window=sliding_window,
                                   pad_len=pad_len)
            if window:
                KC.window_append_capped(cache, k, v, active=active)
            else:
                KC.prefill_extend(cache, k, v, qcfg, prev_len)
    elif mode == "decode":
        per_row = isinstance(cache.seq_len, torch.Tensor)
        if fp:
            if per_row:
                fp_append_masked(cache, k, v, active)
            else:
                fp_append(cache, k, v)
            out = fp_decode_attention(q, cache,
                                      sliding_window=sliding_window,
                                      pad_len=pad_len,
                                      fill_bound=fill_bound)
        else:
            if window:
                KC.window_append_capped(cache, k, v, active=active)
            elif per_row:
                # per-row windows on the device: masked slice writes,
                # each row flushing its own (the batcher) or none
                KC.decode_append_masked(cache, k, v, qcfg, active=active,
                                        do_flush=flush)
            else:
                KC.decode_append(cache, k, v, qcfg, do_flush=flush)
            out = decode_attention(q, cache, qcfg,
                                   sliding_window=sliding_window,
                                   pad_len=pad_len, fill_bound=fill_bound,
                                   shared=shared)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out


def _decoder_layer(x, lp, cache, cfg, qcfg, positions, *, mode, flush=True,
                   pad_len=None, prev_len=0, active=None, fill_bound=None,
                   layer=0, ingest="quant", tp=None, seq_group=None,
                   shared=0):
    h = _attention_block(rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps), lp,
                         cache, cfg, qcfg, positions, mode=mode,
                         flush=flush, pad_len=pad_len, prev_len=prev_len,
                         active=active, fill_bound=fill_bound, layer=layer,
                         ingest=ingest, tp=tp, seq_group=seq_group,
                         shared=shared)
    x = x + h
    mlp = swiglu_mlp(rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps),
                     lp["wg"], lp["wu"], lp["wd"])
    return x + all_reduce_(mlp, tp)


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
            fill_bound: Optional[int] = None, ingest: str = "quant",
            tp=None, seq_group=None, shared: int = 0,
            expert_log=None) -> Tuple[torch.Tensor, List]:
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

    shared: decode mode over the KIVI cache's per-row counters, a static
    count of leading quantized positions that every row holds bit-equal
    to row 0 (the engine's caches behind a fanned-out prefix): attention
    takes the shared-prefix route (core.attention.decode_attention); 0
    keeps row 6 alone.

    ingest: "window" appends K/V to the fp windows only (decode and
    extend modes; `_attention_block`), the speculative decoders' ingest;
    with last_only=False an extend returns every position's logits, as
    their verify needs.

    tp: the tensor-parallel process group (params and cfg are this rank's
    slice; None: the whole model, no collective).  seq_group: prefill
    only, a `parallel.ring.SeqGroup`: tokens and positions are this
    rank's block of slots, attention is the ring over the group, every
    rank's caches receive the whole prompt in token order, and the
    logits are the last true token's (B, 1, vocab), computed by the
    rank holding it and broadcast.

    An `ExaoneMoEConfig` runs its own block (`_hybrid_forward`);
    expert_log: an `ExpertLog` its expert layers log their tokens to.

    Returns (logits (B, T, vocab) f32, caches); with last_only the logits
    are (B, 1, vocab) for the final position."""
    if isinstance(cfg, ExaoneMoEConfig):
        return _hybrid_forward(
            params, tokens, caches, cfg, qcfg, positions, mode=mode,
            last_only=last_only, flush=flush, pad_len=pad_len,
            prev_len=prev_len, active=active, fill_bound=fill_bound,
            ingest=ingest, tp=tp, seq_group=seq_group, shared=shared,
            expert_log=expert_log)
    if seq_group is not None and mode != "prefill":
        raise ValueError("seq_group= is a prefill-only layout")
    x = params["embed"][tokens]
    for i, (lp, cache) in enumerate(zip(params["layers"], caches)):
        x = _decoder_layer(x, lp, cache, cfg, qcfg, positions, mode=mode,
                           flush=flush, pad_len=pad_len, prev_len=prev_len,
                           active=active, fill_bound=fill_bound, layer=i,
                           ingest=ingest, tp=tp, seq_group=seq_group,
                           shared=shared)
    if seq_group is not None:
        logits = None
        if seq_group.rank == seq_group.owner:
            j = seq_group.last_index % x.shape[1]
            logits = _logits(x[:, j:j + 1], params, cfg, tp)
        logits = seq_group.from_owner(
            logits, (x.shape[0], 1, cfg.vocab_size), torch.float32, x.device)
        return logits, caches
    if last_only:
        x = x[:, -1:]
    return _logits(x, params, cfg, tp), caches


# ---------------------------------------------------------------------------
# the K-EXAONE block (ExaoneMoEConfig): sliding layers on rings, full layers
# on the KIVI (or fp) cache, post-norms, QK-norm, sparse experts
# ---------------------------------------------------------------------------

def _unsupported(what: str):
    return NotImplementedError(
        f"{what} is not supported with the sliding-ring layers of an "
        "ExaoneMoEConfig (a ring slot holds a position, not a pad, a row "
        "rollback or a shard)")


def reject_rings(cfg: ModelConfig, what: str) -> None:
    """Raise NotImplementedError naming `what` for an ExaoneMoEConfig:
    the paths not ported to its rings call this first."""
    if isinstance(cfg, ExaoneMoEConfig):
        raise _unsupported(what)


def _hybrid_forward(params, tokens, caches, cfg: ExaoneMoEConfig, qcfg,
                    positions, *, mode, last_only, flush, pad_len, prev_len,
                    active, fill_bound, ingest, tp, seq_group, shared,
                    expert_log):
    """forward for an ExaoneMoEConfig: every layer
    x += post_attn_norm(attn(x)), then x += post_mlp_norm(mlp(x)).  Left
    pads, the window-only ingest, frozen rows, tensor and sequence
    parallel raise."""
    for arg, what in ((pad_len, "pad_lens="), (active, "active="),
                      (tp, "tensor parallel (tp=)"),
                      (seq_group, "a sequence-parallel prefill (seq_group=)")):
        if arg is not None:
            raise _unsupported(what)
    if ingest != "quant":
        raise _unsupported(f"ingest={ingest!r}")
    eps = cfg.rms_norm_eps
    x = params["embed"][tokens]
    for i, (lp, cache) in enumerate(zip(params["layers"], caches)):
        h = _hybrid_attention(x, lp, cache, cfg, qcfg, positions, i,
                              mode=mode, flush=flush, prev_len=prev_len,
                              fill_bound=fill_bound, shared=shared)
        x = x + rms_norm(h, lp["ln_post_attn"], eps)
        h = (swiglu_mlp(x, lp["wg"], lp["wu"], lp["wd"])
             if i < cfg.first_k_dense else moe_mlp(x, lp, cfg, expert_log))
        x = x + rms_norm(h, lp["ln_post_mlp"], eps)
    if last_only:
        x = x[:, -1:]
    return _logits(x, params, cfg, None), caches


def _hybrid_attention(x, lp, cache, cfg: ExaoneMoEConfig, qcfg, positions,
                      layer: int, *, mode, flush, prev_len, fill_bound,
                      shared):
    """QK-norm, RoPE on sliding layers only, then a sliding layer's ring
    (`cache.ring_cache`) or a full layer's cache (`_cache_attention`,
    with no window).  Returns the output projection (B, T, Hd)."""
    B, T, _ = x.shape
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ lp["wq"]).reshape(B, T, Hq, D)
    k = (x @ lp["wk"]).reshape(B, T, Hkv, D)
    v = (x @ lp["wv"]).reshape(B, T, Hkv, D).transpose(1, 2)
    q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps).transpose(1, 2)
    k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps).transpose(1, 2)
    if cfg.rotates(layer):
        cos, sin = rope_cos_sin(positions, D, cfg.rope_theta,
                                cfg.rope_scaling, cfg=cfg)
        cos, sin = cos[:, None], sin[:, None]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    check_finite(k, f"layer {layer}: the keys appended to the cache")
    check_finite(v, f"layer {layer}: the values appended to the cache")
    if not cfg.sliding(layer):
        out = _cache_attention(q, k, v, cache, qcfg, None, mode=mode,
                               flush=flush, prev_len=prev_len,
                               fill_bound=fill_bound, shared=shared)
    elif mode == "prefill":
        out = prefill_attention(q, k, v, sliding_window=cfg.sliding_window)
        RC.ring_prefill(cache, k, v)
    elif mode == "extend":
        out = RC.ring_extend_attention(q, k, v, cache)
        RC.ring_append(cache, k, v)
    elif mode == "decode":
        RC.ring_decode_append(cache, k, v)
        out = RC.ring_decode_attention(q, cache)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = out.transpose(1, 2).reshape(B, T, Hq * D).to(x.dtype)
    return out @ lp["wo"]


def moe_mlp(x, lp, cfg: ExaoneMoEConfig, log=None) -> torch.Tensor:
    """The expert layer over x (B, T, Hd): the sigmoid router over all
    num_experts experts in f32, the experts_per_tok best of score +
    correction bias, their scores normalised (norm_topk_prob) and scaled
    by routed_scaling_factor; the held experts' part of the weighted sum
    (kernels/moe_grouped.py, logged to `log`), plus the shared experts."""
    B, T, Hd = x.shape
    xf = x.reshape(-1, Hd)
    s = torch.sigmoid(xf.float() @ lp["router"].float())
    idx = torch.topk(s + lp["router_bias"], cfg.experts_per_tok,
                     dim=-1).indices
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg.routed_scaling_factor
    out = moe_grouped.experts(xf, idx, w, lp["we_g"], lp["we_u"],
                              lp["we_d"], cfg.experts_here[0], log)
    if cfg.num_shared_experts:
        out = out + swiglu_mlp(xf, lp["ws_g"], lp["ws_u"], lp["ws_d"])
    return out.reshape(B, T, Hd)


def _logits(x, params, cfg: ModelConfig, tp) -> torch.Tensor:
    """Final norm and lm_head, f32; under TP the vocab-split logits are
    gathered (bit-identical on every rank)."""
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    logits = all_gather_last((x @ params["lm_head"]).float(), tp)
    check_finite(logits, "the logits")
    return logits


def init_caches(cfg: ModelConfig, qcfg: QuantConfig, batch: int,
                max_seq_len: int, dtype=torch.bfloat16,
                device=None) -> List:
    """List of per-layer caches, each preallocated at max_seq_len: KIVI
    caches when qcfg.quantize_kv, else fp caches (the baseline)."""
    device = resolve_device(device)
    if isinstance(cfg, ExaoneMoEConfig):
        return _hybrid_caches(cfg, qcfg, batch, max_seq_len, dtype, device)
    if not qcfg.quantize_kv:
        return [init_fp_cache(batch, cfg.num_kv_heads, cfg.head_dim,
                              max_seq_len, dtype, device)
                for _ in range(cfg.num_layers)]
    return [KC.init_layer_cache(batch, cfg.num_kv_heads, cfg.head_dim,
                                max_seq_len, qcfg, dtype, device)
            for _ in range(cfg.num_layers)]


def _hybrid_caches(cfg: ExaoneMoEConfig, qcfg, batch, max_seq_len, dtype,
                   device) -> List:
    """A bf16 ring of sliding_window slots for each sliding layer, the
    KIVI cache (the fp cache when not qcfg.quantize_kv) for each full
    layer."""
    H, D = cfg.num_kv_heads, cfg.head_dim
    return [RC.init_ring_cache(batch, H, D, cfg.sliding_window, dtype,
                               device) if cfg.sliding(i)
            else KC.init_layer_cache(batch, H, D, max_seq_len, qcfg, dtype,
                                     device) if qcfg.quantize_kv
            else init_fp_cache(batch, H, D, max_seq_len, dtype, device)
            for i in range(cfg.num_layers)]


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
    every row's window must be full (the schedule matches the cache).
    Rings (the sliding layers of an ExaoneMoEConfig) have no flush and
    are skipped."""
    W = qcfg.residual_length
    for i, c in enumerate(caches):
        if isinstance(c, RC.RingLayerCache):
            continue
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
    if isinstance(cfg, ExaoneMoEConfig):
        layers = [_hybrid_layer_params(cfg, i, nrm, ones)
                  for i in range(cfg.num_layers)]
        return {"embed": nrm((V, Hd), 1.0), "layers": layers,
                "ln_f": ones(Hd), "lm_head": nrm((Hd, V), s)}
    layers = [{
        "ln_attn": ones(Hd), "ln_mlp": ones(Hd),
        "wq": nrm((Hd, Hq * D), s), "wk": nrm((Hd, Hkv * D), s),
        "wv": nrm((Hd, Hkv * D), s), "wo": nrm((Hq * D, Hd), s),
        "wg": nrm((Hd, I), s), "wu": nrm((Hd, I), s),
        "wd": nrm((I, Hd), I ** -0.5),
    } for _ in range(cfg.num_layers)]
    return {"embed": nrm((V, Hd), 1.0), "layers": layers,
            "ln_f": ones(Hd), "lm_head": nrm((Hd, V), s)}


def _hybrid_layer_params(cfg: ExaoneMoEConfig, i: int, nrm, ones) -> dict:
    """Layer i of an ExaoneMoEConfig: attention with its QK-norms and
    post-norms, then the dense MLP (i < first_k_dense) or the router
    (its correction bias f32, drawn nonzero), the held experts stacked
    (E, in, out) and the shared experts side by side."""
    Hq, Hkv, D, Hd = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.hidden_size)
    s = Hd ** -0.5
    lp = {"wq": nrm((Hd, Hq * D), s), "wk": nrm((Hd, Hkv * D), s),
          "wv": nrm((Hd, Hkv * D), s), "wo": nrm((Hq * D, Hd), s),
          "q_norm": ones(D), "k_norm": ones(D),
          "ln_post_attn": ones(Hd), "ln_post_mlp": ones(Hd)}
    if i < cfg.first_k_dense:
        I = cfg.intermediate_size
        lp.update(wg=nrm((Hd, I), s), wu=nrm((Hd, I), s),
                  wd=nrm((I, Hd), I ** -0.5))
        return lp
    E, Ie = len(cfg.experts_here), cfg.moe_intermediate_size
    Is = Ie * cfg.num_shared_experts
    lp.update(router=nrm((Hd, cfg.num_experts), s),
              router_bias=nrm((cfg.num_experts,), 0.1).float(),
              we_g=nrm((E, Hd, Ie), s), we_u=nrm((E, Hd, Ie), s),
              we_d=nrm((E, Ie, Hd), Ie ** -0.5))
    if Is:
        lp.update(ws_g=nrm((Hd, Is), s), ws_u=nrm((Hd, Is), s),
                  ws_d=nrm((Is, Hd), Is ** -0.5))
    return lp
