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

Two routes each, chosen by `use_split`:

  * fused: one kernel per call — `fused_decode_attention_wide` /
    `fused_decode_attention` for decode (itself split over T in one
    launch), `flash_extend_attention` for extend (one block walks the
    whole history per (row, KV head, query tile));
  * split over T (flash-decoding), the JAX package's route for the
    geometries its fused kernels reject (`kivi_tpu/core/attention.py:
    156-216, 397-444`): decode through `qk_dequant_matmul`, a torch
    softmax and `pv_dequant_matmul`; extend through `flash_extend_qhist`
    and a torch merge with the window and self logits.

Behind a fanned-out prefix (`decode_attention(shared=)`, per-row
counters) decode takes the shared-prefix route
(`kernels/decode_prefix.py`): the rows' common quantized positions are
read once for all rows, each row's own ones by row 6.

GQA: query heads are folded into the KV-head batch (B, Hkv, r, D) and
the quantized operands are never materialized per query head.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.kernels.decode_prefix import shared_decode_attention
from kivi_tpu_torch.kernels.flash import flash_attention
from kivi_tpu_torch.kernels.flash_extend import (
    _extend_ws_logits, flash_extend_attention, flash_extend_attention_rows,
    flash_extend_qhist)
from kivi_tpu_torch.kernels.fused_decode import fused_decode_attention
from kivi_tpu_torch.kernels.fused_decode_wide import SPLIT as _WIDE_SPLIT
from kivi_tpu_torch.kernels.fused_decode_wide import (
    NEG_INF, fused_decode_attention_wide)
from kivi_tpu_torch.kernels.qk_pv import pv_dequant_matmul, qk_dequant_matmul
from kivi_tpu_torch.utils.guards import checking, debug_check

# The split routes' rule.  The fused extend kernel gives one block to
# each (row, KV head, query tile of EXTEND_ROWS rows), and each block
# walks the quantized history chunk by chunk.  With fewer blocks than
# the card has SMs, a long history leaves most SMs idle while a few walk
# it in series; the split routes spread it over T at the cost of a few
# more launches and an O(Tmax) logit pass in torch.  The fused decode
# kernels split over T themselves (256-position splits, in one launch),
# so at decode the split route only adds launches.
#
# SPLIT_MIN_HISTORY is the crossover that chip_smoke.py (phase 3) times
# at batch 1, 8 KV heads, r = 4, KIVI-2 with W = 32, on an H100 80GB
# HBM3 at 700 W (ms, split route vs fused kernel, the host's launch cost
# included), histories 1024, 2048, 4096, 8192, 12032, two runs after the
# split kernels' redesign: decode 0.325, 0.641, 0.328, 0.435, 0.277 and
# 0.512, 0.673, 0.510, 0.768, 0.472 vs 0.030, 0.072, 0.058, 0.065,
# 0.051 and 0.039, 0.082, 0.062, 0.090, 0.081 (the fused kernel wins at
# every history); extend (T1 = 128) 0.650, 0.536, 0.859, 0.793, 0.505
# and 1.111, 0.986, 0.931, 0.742, 0.891 vs 0.105, 0.176, 0.372, 0.672,
# 0.904 and 0.175, 0.223, 0.362, 0.670, 0.972 (the route wins at 12K).
# The split routes' torch part costs ~0.25-0.7 ms of host launches,
# flat in the history.  The threshold is unchanged until the crossover
# is timed over more runs.
SPLIT_BLOCKS = 132          # SMs of an H100 SXM
SPLIT_MIN_HISTORY = 2048    # quantized tokens from which the split wins
EXTEND_ROWS = 128           # query rows per block of the extend kernel


def use_split(blocks: int, n_k_quant) -> bool:
    """True when the split route should serve a call whose fused kernel
    would launch `blocks` blocks over a history of n_k_quant quantized
    tokens.  Host-int counters only: per-row device counters (the
    continuous batcher) keep the fused kernels, since the split kernels
    take one scalar n_quant."""
    return (not isinstance(n_k_quant, torch.Tensor)
            and blocks < SPLIT_BLOCKS and n_k_quant >= SPLIT_MIN_HISTORY)


def t_bound_for(fill_bound: Optional[int], Tmax: int,
                W: int = 0) -> Optional[int]:
    """The decode kernels' static grid bound for a static bound on the
    fill (kivi_tpu/core/attention.py:114-119): one spare split of slack
    (enough splits to hold a window of W), rounded up to the split; None
    (the full grid) when that passes Tmax."""
    if fill_bound is None:
        return None
    split = _WIDE_SPLIT
    slack = split * max(1, -(-W // split))
    tb = -(-(int(fill_bound) + slack) // split) * split
    return tb if tb <= Tmax else None


def decode_attention(q: torch.Tensor, cache: KiviLayerCache,
                     qcfg: QuantConfig, *,
                     sliding_window: Optional[int] = None,
                     pad_len: Optional[torch.Tensor] = None,
                     fill_bound: Optional[int] = None, shared: int = 0
                     ) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, Hq, 1, D) post-RoPE queries for the token just appended to the
    cache (position cache.seq_len - 1).  Returns (B, Hq, 1, D) f32.

    pad_len: optional (B,) int — LEFT-padding slots at the front of each
    row's cache, masked as positions < pad_len.  A sliding window is the
    same kind of lower position bound (position t attends positions
    > t - sliding_window), so both fold into one per-row `lo`.

    fill_bound: optional STATIC upper bound on every row's
    cache.seq_len, valid for every call of a captured decode step (the
    engine's prompt_len + steps, the batcher's fullest active slot).
    Rounded by `t_bound_for` and passed to the per-row kernel as its
    t_bound: its grid then stops there instead of covering Tmax.  A
    wrong bound silently truncates attention; under a checked call
    (`Engine(debug=True)`) the contract is checked and a violation
    raises.

    shared: a STATIC count of leading quantized positions that every row
    holds bit-equal to row 0 (the engine's caches behind a fanned-out
    prefix; `decode_prefix.shared_positions`), 0 for none.  Per-row
    counters only: the shared-prefix route
    (`decode_prefix.shared_decode_attention`) reads them once for all
    rows and row 6 each row's own positions above them.  Under a checked
    call every row's n_k_quant and n_v_quant must reach it.

    Host-int counters (the engine's `decode_step`) go to
    `fused_decode_attention_wide`, or to the split route when
    `use_split` says so; per-row device counters (the continuous
    batcher's slot caches, the engine's decode step) go to
    `fused_decode_attention`, which reads them on the device."""
    B, Hq, M, D = q.shape
    assert M == 1, "decode_attention is single-token"
    Hkv = cache.k_win.shape[1]
    r = Hq // Hkv
    W = qcfg.residual_length
    per_row = isinstance(cache.n_k_quant, torch.Tensor)
    tb = t_bound_for(fill_bound, cache.max_seq_len, W)
    if tb is not None and checking():
        # the t_bound caller contract (kivi_tpu/core/attention.py:120-131)
        nkq, nvq = cache.n_k_quant, cache.n_v_quant
        if per_row:
            nkq, nvq = nkq.max(), nvq.max()
        debug_check((nkq <= tb) & (nvq + W <= tb),
                    "decode t_bound violated: n_k_quant={nkq} or "
                    "n_v_quant={nvq}+W exceeds t_bound={tb}: attention "
                    "would be silently truncated", nkq=nkq, nvq=nvq, tb=tb)
    if shared:
        if not per_row:
            raise ValueError("decode_attention: shared= needs per-row "
                             "device counters")
        if checking():
            nq = torch.minimum(cache.n_k_quant, cache.n_v_quant).min()
            debug_check(nq >= shared, "decode shared bound violated: a "
                        "row holds {nq} quantized positions, fewer than "
                        "shared={s}", nq=nq, s=shared)
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
    if use_split(B * Hkv, cache.n_k_quant):
        out = _decode_attention_split(q.reshape(B, Hkv, r, D).contiguous(),
                                      cache, qcfg, lo)
        return out.reshape(B, Hq, 1, D)
    args = (q.reshape(B, Hkv, r, D).contiguous(), cache.k_codes,
            cache.k_scale, cache.k_mn, cache.v_codes, cache.v_scale,
            cache.v_mn, cache.k_win, cache.v_win)
    kw = dict(group_size=qcfg.group_size, k_bits=qcfg.k_bits,
              v_bits=qcfg.v_bits, lo=lo)
    if per_row:
        counts = torch.stack([cache.n_k_quant, cache.n_k_win,
                              cache.n_v_quant], dim=1)
        if shared:
            out = shared_decode_attention(*args, counts, shared=shared,
                                          t_bound=tb, **kw)
        else:
            out = fused_decode_attention(*args, counts, t_bound=tb, **kw)
    else:
        out = fused_decode_attention_wide(
            *args, cache.n_k_quant, cache.n_k_win, cache.n_v_quant, **kw)
    return out.reshape(B, Hq, 1, D)


@functools.lru_cache(maxsize=16)
def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _decode_attention_split(qg: torch.Tensor, cache: KiviLayerCache,
                            qcfg: QuantConfig,
                            lo: Optional[torch.Tensor]) -> torch.Tensor:
    """Split decode attention (kivi_tpu/core/attention.py:156-216): the
    QK kernel's logits over the quantized keys and the window logits,
    the lower bound lo (B,) applied in torch, one softmax over the
    concatenation, the PV kernel over p masked at n_v_quant, and the
    value window routed by position.  qg (B, Hkv, r, D) -> (B, Hkv, r, D)
    f32.  Host-int counters; the torch part is kept to few launches,
    since on a batch-1 decode step the host issues them slower than the
    card runs them.  A row whose lower bound masks every position (a pad
    past its last token) has no defined output: the JAX package returns
    a uniform average there, the fused kernels 0."""
    B, Hkv, r, D = qg.shape
    Tmax, W, gs = cache.max_seq_len, qcfg.residual_length, qcfg.group_size
    nkq, nvq = cache.n_k_quant, cache.n_v_quant

    att_q = qk_dequant_matmul(qg, cache.k_codes, cache.k_scale, cache.k_mn,
                              gs, qcfg.k_bits, n_quant=nkq)
    att_w = torch.einsum("bhrd,bhwd->bhrw", qg.float(), cache.k_win.float())
    att_w[..., cache.n_k_win:] = NEG_INF
    if lo is not None:
        lo4 = lo.reshape(B, 1, 1, 1)
        att_q.masked_fill_(_iota(Tmax, qg.device) < lo4, NEG_INF)
        att_w.masked_fill_(_iota(W, qg.device) < lo4 - nkq, NEG_INF)

    p = torch.softmax(torch.cat([att_q, att_w], dim=-1)
                      * (1.0 / math.sqrt(D)), dim=-1)
    p_vq = p[..., :Tmax].contiguous()
    p_vq[..., nvq:] = 0.0
    out_q = pv_dequant_matmul(p_vq, cache.v_codes, cache.v_scale,
                              cache.v_mn, gs, qcfg.v_bits, n_quant=nvq)
    # V window row w holds position nvq + w: its probability sits in the
    # quantized half while below nkq, in the window half above it
    # (`_gather_v_window_probs` in one concatenation; the two agree
    # wherever some position is admitted, since p is then exactly 0 at
    # the masked slots the helper adds)
    p_vw = torch.cat([p[..., nvq:nkq], p[..., Tmax:Tmax + W - (nkq - nvq)]],
                     dim=-1)
    return out_q + torch.einsum("bhrw,bhwd->bhrd", p_vw,
                                cache.v_win.float())


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
    on a fully padded chunk.

    Host-int counters: the full extend kernel serves the call unless
    `use_split` sends it to the qhist route (`_extend_attention_qhist`).
    Per-row device counters (the speculative decoders' verify over slot
    caches or replayed steps) go to the kernel's per-row entry,
    `flash_extend_attention_rows`, which reads each row's counters on
    the device."""
    B, Hq, T1, D = q.shape
    Hkv = cache.k_win.shape[1]
    r = Hq // Hkv
    if isinstance(cache.n_k_quant, torch.Tensor):
        counts = torch.stack([cache.n_k_quant, cache.n_k_win,
                              cache.n_v_quant], dim=1).to(torch.int32)
        out = flash_extend_attention_rows(
            q.reshape(B, Hkv, r * T1, D).contiguous(), cache.k_codes,
            cache.k_scale, cache.k_mn, cache.v_codes, cache.v_scale,
            cache.v_mn, cache.k_win, cache.v_win, k_new.contiguous(),
            v_new.contiguous(), counts, group_size=qcfg.group_size,
            k_bits=qcfg.k_bits, v_bits=qcfg.v_bits, t1=T1,
            sliding_window=sliding_window or 0, pad_len=pad_len)
        return out.reshape(B, Hq, T1, D)
    if use_split(-(-r * T1 // EXTEND_ROWS) * B * Hkv, cache.n_k_quant):
        out = _extend_attention_qhist(
            q.reshape(B, Hkv, r, T1, D), k_new.contiguous(),
            v_new.contiguous(), cache, qcfg, sliding_window=sliding_window,
            pad_len=pad_len)
        return out.reshape(B, Hq, T1, D)
    out = flash_extend_attention(
        q.reshape(B, Hkv, r * T1, D).contiguous(), cache.k_codes,
        cache.k_scale, cache.k_mn, cache.v_codes, cache.v_scale,
        cache.v_mn, cache.k_win, cache.v_win, k_new.contiguous(),
        v_new.contiguous(), cache.n_k_quant, cache.n_k_win,
        cache.n_v_quant, group_size=qcfg.group_size, k_bits=qcfg.k_bits,
        v_bits=qcfg.v_bits, t1=T1, sliding_window=sliding_window or 0,
        pad_len=pad_len)
    return out.reshape(B, Hq, T1, D)


def _extend_attention_qhist(q5: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, cache: KiviLayerCache,
                            qcfg: QuantConfig, *,
                            sliding_window: Optional[int],
                            pad_len: Optional[torch.Tensor]) -> torch.Tensor:
    """qhist extend attention (kivi_tpu/core/attention.py:397-444): the
    kernel's unnormalized flash state over the quantized history, merged
    in torch with the window and causal self logits.  q5 (B, Hkv, r, T1,
    D) -> (B, Hkv, r, T1, D) f32.  Host-int counters.

    The V rows behind the window logits: position n_k_quant + w reads
    v_win row n_k_quant + w - n_v_quant (the window shifted by delta,
    zero past its end).  The JAX package also selects the quantized
    store for positions below n_v_quant, which the window's positions
    never are: the cache keeps n_v_quant <= n_k_quant (the qhist kernel
    raises otherwise)."""
    B, Hkv, r, T1, D = q5.shape
    W, gs = qcfg.residual_length, qcfg.group_size
    nkq, nvq = cache.n_k_quant, cache.n_v_quant
    acc_q, m_q, l_q = flash_extend_qhist(
        q5.reshape(B, Hkv, r * T1, D).contiguous(), cache.k_codes,
        cache.k_scale, cache.k_mn, cache.v_codes, cache.v_scale, cache.v_mn,
        cache.v_win, nkq, nvq, cache.seq_len, group_size=gs,
        k_bits=qcfg.k_bits, v_bits=qcfg.v_bits, t1=T1,
        sliding_window=sliding_window or 0, pad_len=pad_len)
    m_q = m_q.reshape(B, Hkv, r, T1, 1)
    l_q = l_q.reshape(B, Hkv, r, T1, 1)

    s2 = _extend_ws_logits(q5.float(), k_new, cache.k_win, nkq,
                           cache.n_k_win, sliding_window=sliding_window,
                           pad_len=pad_len) * (1.0 / math.sqrt(D))
    delta = nkq - nvq                                      # in [0, W]
    vals = torch.zeros((B, Hkv, W + T1, D), dtype=torch.float32,
                       device=q5.device)
    vals[:, :, :W - delta] = cache.v_win[:, :, delta:]
    vals[:, :, W:] = v_new

    # ---- flash merge of (kernel partial) + (window/self logits) -------
    m = torch.maximum(m_q, s2.amax(dim=-1, keepdim=True))
    a_q = torch.exp(m_q - m)
    p2 = torch.exp(s2 - m)
    l = l_q * a_q + p2.sum(dim=-1, keepdim=True)
    out = acc_q.reshape(B, Hkv, r, T1, D) * a_q + torch.einsum(
        "bhrqj,bhjd->bhrqd", p2, vals)
    return out / torch.where(l > 0, l, 1.0)


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
