#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kivi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases (any failure raises; the exit code is then non-zero):
  1. card: name, and power limit as nvidia-smi reports it;
  2. build: compile every CUDA kernel from kivi_tpu_torch/kernels/csrc;
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes and edge cases, timed with CUDA events beside their
     bound and a one-call PyTorch yardstick (the quantizers bit-equal
     through both entries, the in-place one on whole stores pre-filled
     with a sentinel beside a control that flips one row's predicate,
     and timed at the batcher's step with no row, one row and every row
     flushing beside the quantizer + masked-write sequence it replaces;
     the three tensor-core
     kernels per query row at utils.tolerance's limits, beside a control
     that drops one chunk of keys and must be refused, and their wgmma
     tile alone against torch.matmul; the three split decode kernels (fp,
     and the KIVI body of rows 4 and 6) also bit-equal across two runs,
     the KIVI ones beside a control that drops the first split and must
     be refused; the per-row ones (rows 6 and 9) also under the static
     fill bound a replayed decode step passes them, bit-equal to the
     full grid, and timed beside it; the split decode route's two kernels (rows 7 and 8) at
     n_quant around their 256-position splits, bit-equal across two
     runs, QK's masked positions exactly -1e30, beside a control each);
     row 3's per-row entry (flash_extend_attention_rows) at 8
     slots of FILLS, T1 5 and 9, pads, bits 2/4/8, GQA, a window: per
     query row within EXTEND_RTOL, bit-equal to the host-int entry row by
     row, a control that advances one row's n_k_quant refused;
     the split routes (split decode against
     the fused kernel and against row 6 under the long slice's fill
     bound, the qhist extend route and the fused extend
     kernel against the plain extend) on the same inputs at the long
     slice's geometry, timed at histories of 1K-12K (the crossover behind
     core.attention.SPLIT_MIN_HISTORY); the probe
     path's kernels by the profiler's checker (profile_wide_32k.check):
     every variant of the decode ablation probe (kernels/trimmed.py),
     the wide kernel and the split decode route, at small shapes and at
     the probe path's own 32K geometry, on a flat and a peaked softmax;
  4. the paths at Llama-2-7B width, sharing one set of weights:
     Engine.generate of 8 prompts of 1024 tokens, 128 greedy tokens,
     decode replayed as CUDA graphs over device counters (rows 6 and 9
     under the fill bound),
       * KIVI-2, chunked prefill of 128 (extend + KIVI decode),
       * KIVI-2, one-shot prefill (flash_attention + ingest + decode),
       * the fp16 cache, one-shot prefill (flash_attention + fp decode);
     each path's kernels must launch during its run (counts zeroed just
     before it), and a split prefill + decode must give generate()'s
     tokens; then Engine(debug=True) (the same decode step run eagerly
     as a checked call, with guards) over the first 32 tokens must give
     them too, the same kernels launching;
     then the continuous batcher at the same width on the same weights
     (8 slots, 12 requests of 100-1000 prompt tokens and 16-128 new
     tokens, half greedy, half sampled), each step a replay of the
     graph for its fill bound, three ways:
       * KIVI-2, bucketed one-shot admission (per-row KIVI decode),
       * KIVI-2, chunked admission (prefill_chunk=128),
       * the fp16 cache, bucketed admission (fp decode, per-row lengths);
     each path's kernels must launch and the engine's decode kernel must
     not, and the body run eagerly from the same start must give the
     same tokens over its first 40 steps;
     then the long-context slice at Llama-3.1-8B width: Engine.generate
     at batch 1 of a 12,000-token prompt left-padded to 12,032, chunks
     of 128, a 16,384-token cache, KIVI-2 with group 32 and residual 32
     (the reference's example configuration), 64 greedy tokens; the
     qhist extend kernel and row 6 must launch, with graphs and with
     debug=True; then 32 host-int Engine.decode_step calls fed the graph
     run's tokens take the split decode route (rows 7-8, not row 6), and
     each fed token must lie within phase 5's logit tolerance of the
     route's top logit;
     every decode path reports tokens/s and host ms a step over a timed
     window, and the device busy time and idle share over the profiled
     steps after it (busy and wall both from those steps), with graphs
     and eagerly;
     then the prefix slice at Llama-2-7B width (`phase_prefix`, batch
     8, KIVI-2 and fp16): prefill_prefix of a 1000-token system prompt,
     generate(prefix=) over 8 suffixes of 96, ragged suffixes of 24-96,
     the stream (segment 16), extend by 300, a 2304-token prefix (its
     batch-1 extension takes the qhist route), the snapshot saved and
     loaded, beam search (2 x 4 beams, 512 prompt tokens) without and
     with the prefix, the fp16 engine behind the prefix: each path's
     kernels must launch and its tokens must equal Engine(debug=True)'s;
     the stream must equal generate (greedy and sampled with one seed),
     one beam greedy generate; then prefill_prefix ms, time to first
     token behind the prefix against the full prompt one-shot and
     chunked, decode tokens/s on the prefix and ragged paths, the
     stream's time to first token, beam ms a step and its reorder's,
     snapshot bytes of KIVI-2 and fp16; then the batcher behind a
     PrefixCache of two system prompts (8 slots, chunks of 128, 12
     requests of 20-300 prompt tokens, half sampled: one miss, one
     extend hit, exact hits), directly and over HTTP with "prefix"
     (greedy tokens equal);
     then the speculative slice (`phase_spec`) at Llama-2-7B
     width: the target Engine (KIVI-2) at batch 1 timed alone on
     prompts of 1000 and 2500 tokens (128 greedy tokens); a 2-layer
     "shallow" draft written as an HF safetensors directory by hand,
     read back by load_hf_checkpoint and through save_checkpoint /
     load_checkpoint, bit-equal each time; SpeculativeEngine (k = 8)
     with draft "self" (the target's weights over an fp16 cache) and
     "shallow": generate on both prompts (tokens/s beside the target,
     mean accepted, clamps, host ms an iteration, busy and idle share),
     the stream equal to generate, a sampled run (temperature 0.8,
     top-k 50, top-p 0.95) equal twice under one seed, generate_device
     equal to generate, debug=True equal to the graphs; then
     SpeculativeBatcher (shallow draft, 8 slots, k = 4) over the 12
     requests, its first 40 steps eagerly from the same start equal to
     the graphs'; every path's kernels (row 3's per-row entry on each)
     must launch, and every greedy stream is teacher-forced through the
     target, each token within 5e-2 of the top logit (the share equal
     to Engine.generate's reported);
     then the parallel tier (`phase_parallel`, `[parallel:*]` lines) on
     the (1, 1) mesh one card allows: (a) multihost.initialize at world
     1 over NCCL, global_mesh (1, 1), an all_reduce and an all_gather
     over each axis' group; (b) Engine.prefill_seqpar (the ring, plain
     f32 torch, in place of row 10) at the long slice's geometry,
     contiguous and striped, against the one-shot prefill on the same
     Llama-3.1-8B weights: logits within phase 5's tolerance, layer 0's
     packed K/V words >= 99.9% equal and the 2-bit codes of every
     deeper layer >= 95% equal (the one-shot reference attends in bf16,
     the ring in f32), the one-shot run's 64 greedy tokens
     teacher-forced off the seqpar caches (row 6) each within 5e-2 of
     the top logit; (c) Engine(mesh=) over shard_params of the main
     path's Llama-2-7B weights and prompts, its tokens equal to the
     unsharded one-shot generate; (d) ElasticBatcher (8 slots, the 12
     batcher requests, greedy), recovered onto global_mesh after 20
     steps with requests in flight, every step under a StepWatchdog
     that must not fire, over the fp16 cache and over KIVI-2: every
     request completes, each pre-failure stream is a prefix of its
     final one, and every stream made after the recovery is
     teacher-forced through a batch-1 Engine over the same cache, each
     token within 5e-2 of the top logit; over fp16 the streams not in
     flight at the failure also equal an uninterrupted
     ContinuousBatcher's, and a resumed stream may leave the
     uninterrupted one only at a near tie of the Engine's logits
     (5e-2); recovery ms and generated tokens/s;
     then the probe path: `python3 -m kivi_tpu_torch.profile_wide_32k
     --quick` (B = 4, 32 KV heads, a 32K history), whose wide kernel,
     split decode route and probe variants must launch;
  5. the paths against the plain path: 2 layers at full width on the
     card (kernels) and on the host CPU (plain versions), same weights:
     chunked and one-shot prefill logits of both caches; the long slice
     with a prompt of SPLIT_MIN_HISTORY + 1024 tokens (prefill and one
     decode step's logits, both split routes on both sides); the prefix
     slice (a 300-token prefix: the suffix extend's logits and the
     longest ragged row's teacher-forced logits; the stream equal to
     generate on each side; 2 x 2 beams over 8 replayed steps, the
     host forced onto the card's choices, each chosen continuation's
     log-probability within twice the logit tolerance; token agreement
     of the prefix, ragged and stream paths reported); one speculative
     verify's logits (the engine's over device counters, k + 1 = 9, and
     4 batcher slots, k + 1 = 5) within the same tolerance; the
     sequence-parallel prefill's logits over the (1, 1) mesh, and its
     K/V stores as (b) holds them (layer 0's packed words >= 99.9%
     equal, layer 1's codes >= 95%);
  6. the batcher against the engine on the card (2 layers, full width):
     first tokens equal and one decode step's logits per slot within the
     phase-5 tolerance of batch-1 Engine runs of the same left-padded
     prompts, on both caches; the same for requests with prefix_tokens
     against the batch-1 generate(prefix=) of the same snapshot (KIVI-2
     prompts of one whole chunk, fp16 prompts with tails), and the
     batcher with debug=True giving the graphs' tokens;
  7. ServingAPI on 127.0.0.1 (2 layers): three concurrent requests, one
     streaming, and /v1/health.

Prints the kernels' JSON line, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}.  Exits non-zero without a
result when CUDA is unavailable, or when the script runs without the
kivi_tpu_torch package beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

try:
    from kivi_tpu_torch.utils import tolerance as TOL
    from kivi_tpu_torch.utils.device import card
    from kivi_tpu_torch.utils.timing import bound, cuda_ms
except ModuleNotFoundError as e:
    # run alone, without the package it drives: fail with no result
    raise SystemExit(f"chip_smoke: {e}; run it from the root of a checkout "
                     "of the repository") from None

# Attention tolerance on the card: max|kernel - plain| <= ATT_RTOL *
# max|plain| + ATT_ATOL.  Tighter than bf16 rounding on purpose: every
# kernel but the three tensor-core ones and its plain version both
# dequantize and compute in f32 from the same bf16 inputs (TF32 off), so
# they differ only in summation order and fused multiply-adds, about
# 1e-7 relative.  flash_attention, flash_extend_attention and
# flash_extend_qhist run their products on the tensor cores with bf16
# operands, as the Pallas kernels do, and are held per query row to
# utils.tolerance's FLASH_RTOL, EXTEND_RTOL and QHIST_RTOL (the reasons
# are there); so is the qhist extend route, against the f32
# flash_extend_attention_plain.
ATT_RTOL, ATT_ATOL = 1e-5, 1e-5
B, H, D, TMAX, T1 = 8, 32, 128, 4096, 128
# per-slot fills of the per-row decode checks: divergent, 0 = empty slot
FILLS = (1, 137, 640, 1081, 2048, 3000, 4000, 0)
# the long-context slice: Llama-3.1-8B's attention (8 KV heads, 4 query
# rows each) at batch 1, a 16K cache holding a 12,032-token prompt
LB, LH, LR, LTMAX, LFILL, LPAD, LNEW = 1, 8, 4, 16384, 12032, 32, 64
CROSS_FILLS = (1024, 2048, 4096, 8192, 12032)   # split vs fused timings
# the prefix slice: a 1000-token system prompt (its windows mid-phase),
# the same grown by 300, one past SPLIT_MIN_HISTORY (the qhist route),
# 96-token suffixes (ragged 24-96), 64 new tokens; beams: 2 requests x 4
PREFIX, PREFIX_MORE, PREFIX_LONG, SUFFIX, PNEW = 1000, 300, 2304, 96, 64
RAGGED_MIN = 24
BEAM_B, BEAM_NB, BEAM_PROMPT = 2, 4, 512
NEG_INF = -1e30


def log(*a):
    print(*a, flush=True)


START = time.perf_counter()


def stamp(what: str) -> None:
    log(f"[phase] {what} done at {time.perf_counter() - START:.1f} s")


# ---------------------------------------------------------------------------
# phase 1: card
# ---------------------------------------------------------------------------

def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    smi = card()
    log(f"[card] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from kivi_tpu_torch.kernels import _build
    _build.build_all()
    log(f"[build] {len(_build.SIGNATURES)} libraries in "
        f"{_build.BUILD_SECONDS:.1f} s into {_build.BUILD_DIR}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "arning")):
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_quant(gen, results):
    """Rows 1-2, both entries, bit-equal to their plain versions: the
    contract entry (fresh outputs) at the main path's shapes, on a
    window view and an unaligned base; the in-place entry on whole
    stores pre-filled with a sentinel, rows selected all / one / none /
    every / one host offset, at offsets 0, 128, Tmax (clamped) and 130,
    bf16 and f32 stores, beside a control (row 0 flipped) that must be
    refused (profile_quant.check_into); the same at the main path's
    shapes (profile_quant.MAIN_PATH_INTO: the batcher's flush with
    device offsets, the one-shot ingest, the long slice's flush and
    chunk at host offsets).  Timed: the contract entry at one
    (8, 32, 128, 128) block; the in-place entry at the batcher's step
    with no row, one row and every row flushing, beside the sequence the
    slot cache ran without it (the contract entry, then three masked
    gather/where/scatter writes)."""
    from kivi_tpu_torch import profile_quant as PQ8
    from kivi_tpu_torch.kernels import quant_pack as QP
    gs = 32
    for is_key in (True, False):
        name = "quantize_pack_k" if is_key else "quantize_pack_v"
        kern = QP.quantize_pack_k if is_key else QP.quantize_pack_v
        plain = QP.quantize_pack_k_plain if is_key else \
            QP.quantize_pack_v_plain
        worst = 0.0
        for bits in (2, 4, 8):
            for T in (128, 1024):
                x = _randn(gen, (B, H, T, D))
                x[0, 0, :gs, :] = 0.5              # a constant group
                got, want = kern(x, gs, bits), plain(x, gs, bits)
                torch.cuda.synchronize()
                for g, w, what in zip(got, want, ("codes", "scale", "mn")):
                    # tolerance: none - codes, scale and min bit-equal
                    err = (g.double() - w.double()).abs().max().item()
                    worst = max(worst, err)
                    if not torch.equal(g, w.contiguous()):
                        raise AssertionError(
                            f"{name} bits={bits} T={T}: {what} differ "
                            f"({(g != w).sum().item()} elements, max "
                            f"|diff| {err})")
                log(f"[kernel] {name} bits={bits} T={T}: bit-equal")
            for layout in ("window", "unaligned"):
                PQ8.check_fresh(is_key, bits, gs, (2, 8, 128, D), layout)
            for sdt in (torch.float32, torch.bfloat16):
                for mode in PQ8.MODES:
                    PQ8.check_into(is_key, bits, gs, 128, sdt, mode)
            log(f"[kernel] {name} bits={bits}: window view and unaligned "
                f"base bit-equal; in-place entry bit-equal on whole stores "
                f"at {PQ8.MODES}, f32 and bf16 stores, controls refused")
        cases = PQ8.check_into_main_path(is_key)
        log(f"[kernel] {name}: in-place entry bit-equal on whole stores at "
            f"the main path's shapes (KIVI-2, bf16 stats), controls "
            f"refused: {'; '.join(cases)}")
        PQ8.check_into(is_key, 2, 16, 32, torch.bfloat16, "all")
        PQ8.check_into(is_key, 2, gs, 32, torch.bfloat16, "one", D_=64)
        log(f"[kernel] {name}: runtime-shape kernel (gs 16; D 64) in place "
            "bit-equal")
        t = PQ8.time_kind(is_key, reps=1)
        bms, by = bound(PQ8.fresh_bytes(B, H, 128, D), 0)
        results[name] = dict(
            max_abs_err=worst, ms=t["fresh_8x32x128x128"][0],
            plain_ms=t["plain"], bound_ms=bms, bound_by=by, library_ms=None,
            **{f"{k}_ms": (v[0] if isinstance(v, list) else v)
               for k, v in t.items() if k.startswith(("into", "masked"))})
        log(f"[kernel] {name} in place at the batcher's step (8 slots, 32 "
            f"heads, W 128, Tmax 4096, bf16 stats): no row "
            f"{t['into_none'][0]:.4f} ms, one {t['into_one'][0]:.4f}, all "
            f"{t['into_all'][0]:.4f} (bound {t['into_all_bound']:.5f}) | "
            f"quantizer + 3 masked writes {t['masked_seq'][0]:.4f} ms | "
            f"host enqueue counted: one row {t['into_one_host'][0]:.4f} vs "
            f"{t['masked_seq_host'][0]:.4f} ms")


def _filled_cache(gen, qcfg, fill: int, heads: int = H, batch: int = B,
                  tmax: int = TMAX, d: int = D):
    """A (batch, heads, d, tmax) cache holding `fill` tokens, the last one
    just appended by decode_append (the state decode attention reads)."""
    from kivi_tpu_torch.cache import kivi_cache as KC
    c = KC.init_layer_cache(batch, heads, d, tmax, qcfg, device="cuda")
    if fill > 1:
        KC.prefill_ingest(c, _randn(gen, (batch, heads, fill - 1, d)),
                          _randn(gen, (batch, heads, fill - 1, d)), qcfg)
    KC.decode_append(c, _randn(gen, (batch, heads, 1, d)),
                     _randn(gen, (batch, heads, 1, d)), qcfg)
    return c


def _ingested_cache(gen, qcfg, fill: int, heads: int = LH, batch: int = LB,
                    tmax: int = LTMAX):
    """A cache holding a `fill`-token prompt as prefill left it (the state
    the next prefill chunk's extend attention reads)."""
    from kivi_tpu_torch.cache import kivi_cache as KC
    c = KC.init_layer_cache(batch, heads, D, tmax, qcfg, device="cuda")
    if fill:
        KC.prefill_ingest(c, _randn(gen, (batch, heads, fill, D)),
                          _randn(gen, (batch, heads, fill, D)), qcfg)
    return c


def _deq_kv(c, qcfg, upto: int):
    """The cache's first `upto` positions of K and V, dequantized /
    copied to bf16 (B, H, upto, D): the library yardstick's operands."""
    from kivi_tpu_torch.core import quant as Q
    k = Q.dequantize_k(c.k_codes, c.k_scale, c.k_mn, qcfg.group_size,
                       qcfg.k_bits).transpose(-1, -2)[:, :, :c.n_k_quant]
    v = Q.dequantize_v(c.v_codes, c.v_scale, c.v_mn, qcfg.group_size,
                       qcfg.v_bits)[:, :, :c.n_v_quant]
    k = torch.cat([k, c.k_win[:, :, :c.n_k_win].float()], dim=2)
    v = torch.cat([v, c.v_win[:, :, :c.n_v_win].float()], dim=2)
    return (k[:, :, :upto].to(torch.bfloat16).contiguous(),
            v[:, :, :upto].to(torch.bfloat16).contiguous())


def _live_bytes(qcfg, sb, nkq, nkw, nvq, nvw):
    """Bytes of one (row, KV head)'s live cache: codes, stats, windows."""
    kdw, vdw = D // (32 // qcfg.k_bits), D // (32 // qcfg.v_bits)
    gs = qcfg.group_size
    return (nkq * kdw * 4 + 2 * (nkq // gs) * D * sb + nvq * vdw * 4
            + 2 * (D // gs) * nvq * sb + (nkw + nvw) * D * 2)


def _cache_bytes(c, qcfg):
    """Bytes of the live part of a (B, H) cache with host-int counters."""
    return B * H * _live_bytes(qcfg, c.k_scale.element_size(), c.n_k_quant,
                               c.n_k_win, c.n_v_quant, c.n_v_win)


def _att_err(got, want, what):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= ATT_RTOL * scale
            + ATT_ATOL):
        raise AssertionError(f"{what}: max|kernel - plain| = {err:.3e} "
                             f"> {ATT_RTOL} * {scale:.3e} + {ATT_ATOL}")
    log(f"[kernel] {what}: max|kernel - plain| = {err:.3e} "
        f"(max|plain| {scale:.3e})")
    return err


def _control_refused(ctrl, want, what, how="without the first split"):
    """A control (by default a kernel's output without its first split)
    must miss the plain version by more than the attention tolerance."""
    err = (ctrl - want).abs().max().item()
    limit = ATT_RTOL * want.abs().max().item() + ATT_ATOL
    if err <= limit:
        raise AssertionError(f"{what}: the check passed a control {how}")
    log(f"[kernel] {what}: control {how} refused, "
        f"max|diff| {err:.3e} = {err / limit:.1f}x the limit")


def _twice(fn, what):
    """Run a kernel twice: the two outputs must be bit-equal."""
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two runs differ")
    return got


def check_decode(gen, results):
    """Row 4 (split over T in SPLIT-position splits) against its plain
    version: fills around the split size, 1081 (the main path) and Tmax
    at bits 2/4/8; n_v_quant < n_k_quant; a window across two splits
    with a first split straddling n_v_quant < n_k_quant ("span"); left
    pads ("pad", rows 0-259; "padx", rows 0-1050, whole splits dead) and
    a sliding window; r 1/4/8, f32 scales, D = 64; every case bit-equal
    across two runs; a control without the first split refused."""
    import torch.nn.functional as F

    from kivi_tpu_torch import profile_wide_32k as PW
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.kernels import fused_decode_wide as FD
    name = "fused_decode_attention_wide"
    S = FD.SPLIT
    worst = 0.0
    # (bits, v_flush, fill, mask, KV heads, query rows per KV head, scale
    # dtype, D)
    bf, f32 = "bfloat16", "float32"
    cases = [(bits, 128, fill, None, H, 1, bf, D) for bits in (2, 4, 8)
             for fill in (1, 1024 + 57, TMAX)]
    cases += [(2, 128, fill, None, H, 1, bf, D)
              for fill in (S - 1, S, S + 1, 2 * S + 57)]
    cases += [(2, 32, 1024 + 57, None, H, 1, bf, D),  # n_v_quant < n_k_quant
              (2, 128, 1024 + 57, "pad", H, 1, bf, D),
              (4, 32, 1024 + 57, "swa", H, 1, bf, D),   # lo = seq_len - 1000
              (2, 128, 1024 + 57, "pad", 8, 4, bf, D),  # Llama-3 GQA geometry
              (2, 128, 1024 + 57, "padx", H, 1, bf, D),
              (2, 128, "span", None, H, 1, bf, D),
              (4, 128, "span", "pad", 8, 4, bf, D),
              (8, 32, 1024 + 57, "padx", 8, 8, f32, D),
              (4, 32, 2 * S + 57, "pad", 8, 4, f32, 64)]
    timed = None
    for bits, vf, fill, mask, heads, r, sdt, d in cases:
        if fill == "span":
            # n_k_quant 200, n_k_win 100, n_v_quant 180 (W 128): the
            # window spans splits 0 and 1, split 0 straddles n_v_quant
            q, c = PW.make_cache(B, TMAX, 200, heads=heads, r=r, bits=bits,
                                 seed=bits + r, data="normal")
            c.n_k_win, c.n_v_quant, c.n_v_win = 100, 180, 120
        else:
            qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf,
                               scale_dtype=sdt)
            c = _filled_cache(gen, qcfg, fill, heads, d=d)
            q = _randn(gen, (B, heads, r, d))
        lo = None
        if mask == "pad":
            lo = torch.arange(B, device="cuda", dtype=torch.int32) * 37
        elif mask == "padx":
            lo = torch.arange(B, device="cuda", dtype=torch.int32) * 150
        elif mask == "swa":
            lo = torch.full((B,), c.seq_len - 1000, device="cuda",
                            dtype=torch.int32)
        args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.k_win, c.v_win, c.n_k_quant, c.n_k_win,
                c.n_v_quant)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, lo=lo)
        what = (f"{name} bits={bits} vf={vf} fill={fill} mask={mask} "
                f"Hkv={heads} r={r} {sdt} D={d} (nkq={c.n_k_quant} "
                f"nkw={c.n_k_win} nvq={c.n_v_quant})")
        got = _twice(lambda: FD.fused_decode_attention_wide(*args, **kw),
                     what)
        want = FD.fused_decode_attention_wide_plain(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _att_err(got, want, what + " (two runs "
                                                      "bit-equal)"))
        if (bits, vf, fill, mask, r) == (2, 128, 1024 + 57, None, 1):
            timed = (c, qcfg, args, kw, q, want)
    c, qcfg, args, kw, q, want = timed
    # control: the kernel's own output without its first split (a lower
    # bound at the split size) must be refused
    first = torch.full((B,), S, device="cuda", dtype=torch.int32)
    _control_refused(
        FD.fused_decode_attention_wide(*args, **{**kw, "lo": first}), want,
        f"{name} fill {c.seq_len}")
    k, v = _deq_kv(c, qcfg, c.seq_len)
    nbytes = _cache_bytes(c, qcfg) + q.numel() * 2 + B * H * D * 4
    bms, by = bound(nbytes, 4 * B * H * c.seq_len * D)
    results[name] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: FD.fused_decode_attention_wide(*args, **kw)),
        plain_ms=cuda_ms(
            lambda: FD.fused_decode_attention_wide_plain(*args, **kw)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v)))
    log(f"[kernel] {name} timed at fill {c.seq_len}, KIVI-2, B={B}")


def _slot_cache(gen, qcfg, heads, fills=FILLS):
    """A slot cache (per-row device counters) whose row s holds fills[s]
    tokens, the last one appended by decode_append (0: an empty slot)."""
    from kivi_tpu_torch.cache import kivi_cache as KC
    slots = KC.init_slot_cache(len(fills), heads, D, TMAX, qcfg,
                               device="cuda")
    for s, fill in enumerate(fills):
        one = KC.init_layer_cache(1, heads, D, TMAX, qcfg, device="cuda")
        if fill > 1:
            KC.prefill_ingest(one, _randn(gen, (1, heads, fill - 1, D)),
                              _randn(gen, (1, heads, fill - 1, D)), qcfg)
        if fill:
            KC.decode_append(one, _randn(gen, (1, heads, 1, D)),
                             _randn(gen, (1, heads, 1, D)), qcfg)
        KC.write_slot(slots, s, one)
    return slots


def _row_counts(c):
    """The per-row counters of a slot cache, read to the host."""
    return list(zip(*(getattr(c, n).tolist() for n in (
        "n_k_quant", "n_k_win", "n_v_quant", "n_v_win"))))


def check_fused_decode_rows(gen, results):
    """Row 6 (per-row device counters, split over T) at FILLS, one slot
    empty: bits 2/4/8, r 1/4/8, bf16 and f32 scales, pads and each row's
    own sliding window; within the tolerance, the empty row exactly 0,
    every case bit-equal across two runs; a control without the first
    split refused; at counters equal on every row, row 4's function."""
    import torch.nn.functional as F

    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.core import quant as Q
    from kivi_tpu_torch.kernels import fused_decode as FR
    from kivi_tpu_torch.kernels import fused_decode_wide as FD
    name = "fused_decode_attention"
    worst = 0.0
    S = len(FILLS)
    pad = torch.tensor([0, 0, 37, 300, 1000, 5, 3999, 0], device="cuda",
                       dtype=torch.int32)
    # (bits, v_flush, KV heads, query rows per KV head, lower bound, scale
    # dtype); the batcher's main path runs the first
    cases = [(2, 128, H, 1, None, "bfloat16")]
    cases += [(bits, 32, heads, r, "pad", "bfloat16") for bits in (2, 4, 8)
              for heads, r in ((H, 1), (8, 4))]
    cases += [(4, 32, H, 1, "swa", "bfloat16"),
              (8, 128, 8, 4, "swa", "bfloat16"),
              (2, 32, 8, 8, "pad", "bfloat16"), (4, 32, H, 1, None, "float32")]
    timed = None
    for bits, vf, heads, r, mask, sdt in cases:
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf, scale_dtype=sdt)
        c = _slot_cache(gen, qcfg, heads)
        rows = _row_counts(c)
        if vf < 128 and not any(nkq > nvq for nkq, _, nvq, _ in rows):
            raise AssertionError(f"{name}: no row with n_k_quant > "
                                 "n_v_quant")
        q = _randn(gen, (S, heads, r, D))
        lo = None
        if mask == "pad":
            lo = pad
        elif mask == "swa":                 # each row's own window
            lo = torch.clamp(c.seq_len - 1000, min=0)
        counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
        args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.k_win, c.v_win, counts)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, lo=lo)
        what = (f"{name} bits={bits} vf={vf} Hkv={heads} r={r} mask={mask}"
                f" {sdt} fills={FILLS}")
        got = _twice(lambda: FR.fused_decode_attention(*args, **kw), what)
        want = FR.fused_decode_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _att_err(got, want, what + " (two runs "
                                                      "bit-equal)"))
        if got[FILLS.index(0)].abs().max() != 0:
            raise AssertionError(f"{what}: the empty row is not 0")
        log(f"[kernel] {what}: empty row exactly 0; (n_k_quant, n_k_win, "
            f"n_v_quant) per row {[x[:3] for x in rows]}")
        if (bits, vf, r, mask) == (2, 128, 1, None):
            timed = (c, qcfg, args, kw, q, rows, want)
    # at counters equal on every row it is the wide kernel's function
    for bits in (2, 4, 8):
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=32)
        c = _filled_cache(gen, qcfg, 1081, H)
        q = _randn(gen, (B, H, 1, D))
        arrays = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                  c.v_mn, c.k_win, c.v_win)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits,
                  lo=torch.arange(B, device="cuda", dtype=torch.int32) * 37)
        counts = torch.tensor([[c.n_k_quant, c.n_k_win, c.n_v_quant]] * B,
                              device="cuda", dtype=torch.int32)
        got = FR.fused_decode_attention(*arrays, counts, **kw)
        want = FD.fused_decode_attention_wide(
            *arrays, c.n_k_quant, c.n_k_win, c.n_v_quant, **kw)
        torch.cuda.synchronize()
        _att_err(got, want, f"{name} bits={bits} uniform fill 1081 vs "
                            "fused_decode_attention_wide")

    c, qcfg, args, kw, q, rows, want = timed
    # control: every row without its first split must be refused
    first = torch.full((S,), FD.SPLIT, device="cuda", dtype=torch.int32)
    _control_refused(FR.fused_decode_attention(*args, **{**kw, "lo": first}),
                     want, f"{name} fills {FILLS}")
    sb = c.k_scale.element_size()
    nbytes = (sum(H * _live_bytes(qcfg, sb, *x) for x in rows)
              + q.numel() * 2 + S * H * D * 4 + S * 3 * 4)
    bms, by = bound(nbytes, 4 * H * D * sum(FILLS))
    # yardstick: SDPA over each row's cache dequantized to bf16, a per-row
    # boolean mask over the longest fill
    L = max(FILLS)
    k = torch.zeros((S, H, L, D), dtype=torch.bfloat16, device="cuda")
    v = torch.zeros_like(k)
    k_deq = Q.dequantize_k(c.k_codes, c.k_scale, c.k_mn, 32,
                           2).transpose(-1, -2)
    v_deq = Q.dequantize_v(c.v_codes, c.v_scale, c.v_mn, 32, 2)
    for s_, (nkq, nkw, nvq, nvw) in enumerate(rows):
        k[s_, :, :nkq] = k_deq[s_, :, :nkq].to(torch.bfloat16)
        k[s_, :, nkq:nkq + nkw] = c.k_win[s_, :, :nkw]
        v[s_, :, :nvq] = v_deq[s_, :, :nvq].to(torch.bfloat16)
        v[s_, :, nvq:nvq + nvw] = c.v_win[s_, :, :nvw]
    mask = (torch.arange(L, device="cuda")[None, :]
            < torch.tensor(FILLS, device="cuda")[:, None])[:, None, None]
    del k_deq, v_deq
    results[name] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: FR.fused_decode_attention(*args, **kw)),
        plain_ms=cuda_ms(lambda: FR.fused_decode_attention_plain(
            *args, **kw)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)))
    log(f"[kernel] {name} timed at S={S} slots, fills {FILLS}, KIVI-2 "
        f"(vf 128), H={H}, r=1: live bytes {nbytes / 1e6:.2f} MB")


def check_extend(gen, results):
    import torch.nn.functional as F

    from kivi_tpu_torch.cache import kivi_cache as KC
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.kernels import flash_extend as FE
    name = "flash_extend_attention"
    worst = 0.0
    timed = None
    # (history fill, pad of rows 1.., sliding window, KV heads, r, bits,
    # v_flush, T1); the main path's chunks see fills 0, 128, ..., 896
    cases = [(0, None, 0, H, 1, 2, 128, T1), (128, None, 0, H, 1, 2, 128, T1),
             (896, None, 0, H, 1, 2, 128, T1),
             (128, 200, 0, H, 1, 2, 128, T1),
             (0, 60, 0, H, 1, 2, 128, T1),
             (200, None, 100, H, 1, 4, 32, T1),      # sliding window
             (384, 150, 0, 8, 4, 8, 32, T1)]         # Llama-3 GQA, 8-bit
    # the prefix paths: a 1000-token snapshot leaves 104 keys in the
    # window, its 300-token extension 76; they take the batcher's chunks
    # (T1 128), the suffixes (96), the shortest ragged suffix (24) and
    # the extension (300); the 2304-token snapshot the suffixes at batch 8
    cases += [(fill, None, 0, H, 1, 2, 128, t1)
              for fill in (PREFIX, PREFIX + PREFIX_MORE)
              for t1 in (T1, SUFFIX, RAGGED_MIN, PREFIX_MORE)]
    cases.append((PREFIX_LONG, None, 0, H, 1, 2, 128, SUFFIX))
    for fill, pad, sw, heads, r, bits, vf, t1 in cases:
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf)
        c = KC.init_layer_cache(B, heads, D, TMAX, qcfg, device="cuda")
        if fill:
            KC.prefill_ingest(c, _randn(gen, (B, heads, fill, D)),
                              _randn(gen, (B, heads, fill, D)), qcfg)
        q = _randn(gen, (B, heads, r * t1, D))
        kn = _randn(gen, (B, heads, t1, D))
        vn = _randn(gen, (B, heads, t1, D))
        pad_len = None
        if pad is not None:
            pad_len = torch.full((B,), pad, device="cuda",
                                 dtype=torch.int32)
            pad_len[0] = 0
        args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.k_win, c.v_win, kn, vn, c.n_k_quant, c.n_k_win,
                c.n_v_quant)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=t1,
                  sliding_window=sw, pad_len=pad_len)
        got = FE.flash_extend_attention(*args, **kw)
        want = FE.flash_extend_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        what = (f"{name} fill={fill} T1={t1} pad={pad} window={sw} "
                f"Hkv={heads} r={r} bits={bits} vf={vf} (nkq={c.n_k_quant} "
                f"nvq={c.n_v_quant})")
        worst = max(worst, _rows_err(got, want, what, TOL.EXTEND_RTOL))
        if (fill, pad, sw, r, t1) == (896, None, 0, 1, T1):
            timed = (c, args, kw, q, kn, vn)
            # control: the kernel's own output without the history's
            # first 64 positions (the kernel at a left pad of 64)
            ctrl = FE.flash_extend_attention(*args, **dict(
                kw, pad_len=torch.full((B,), 64, device="cuda",
                                       dtype=torch.int32)))
            _refused(TOL.row_share(ctrl, want, TOL.EXTEND_RTOL).max().item(),
                     f"{name} fill={fill}: control that drops the first 64 "
                     "history positions")
    qcfg = QuantConfig(2, 2, 32, 128, v_flush=128)
    c, args, kw, q, kn, vn = timed
    T0 = c.seq_len
    k, v = _deq_kv(c, qcfg, T0)
    k, v = torch.cat([k, kn], dim=2), torch.cat([v, vn], dim=2)
    mask = torch.ones(T1, T0 + T1, dtype=torch.bool,
                      device="cuda").tril(diagonal=T0)
    nbytes = (_cache_bytes(c, qcfg) + 3 * q.numel() * 2
              + q.numel() * 4)
    pairs = T1 * T0 + T1 * (T1 + 1) // 2           # causal (row, key)
    bms, by = bound(nbytes, 4 * B * H * pairs * D)
    results[name] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: FE.flash_extend_attention(*args, **kw)),
        plain_ms=cuda_ms(lambda: FE.flash_extend_attention_plain(
            *args, **kw)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)))
    log(f"[kernel] {name} timed at {T0} cached tokens + T1={T1}, "
        f"KIVI-2, B={B}")


def check_extend_rows(gen, results):
    """Row 3's per-row entry (flash_extend_attention_rows, the speculative
    verify over slot caches) at 8 slots of row 6's FILLS (one empty),
    T1 = k + 1 = 5 and 9, left pads on some rows, bits 2/4/8, GQA and a
    sliding window: per query row within EXTEND_RTOL of the per-row plain
    version, and bit-equal to the host-int entry launched row by row at
    each row's counters; a control that advances one row's n_k_quant by
    one group must be refused.  Timed at the batcher's verify (KIVI-2,
    T1 = 5) beside its bound and SDPA over each row's cache dequantized
    to bf16 (a per-row causal mask)."""
    import torch.nn.functional as F

    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.core import quant as Q
    from kivi_tpu_torch.kernels import flash_extend as FE
    name = "flash_extend_attention_rows"
    S = len(FILLS)
    pads = torch.tensor([0, 0, 37, 100, 0, 5, 999, 0], device="cuda",
                        dtype=torch.int32)
    # (bits, v_flush, KV heads, query rows per KV head, T1, pads, window)
    cases = [(2, 128, H, 1, 5, False, 0), (2, 128, H, 1, 9, True, 0),
             (4, 32, H, 1, 9, True, 0), (8, 32, 8, 4, 5, True, 0),
             (2, 128, 8, 4, 9, False, 1000)]
    worst, timed = 0.0, None
    for bits, vf, heads, r, t1, padded, sw in cases:
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf)
        c = _slot_cache(gen, qcfg, heads)
        counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant],
                             dim=1).contiguous()
        arrays = (_randn(gen, (S, heads, r * t1, D)), c.k_codes, c.k_scale,
                  c.k_mn, c.v_codes, c.v_scale, c.v_mn, c.k_win, c.v_win,
                  _randn(gen, (S, heads, t1, D)),
                  _randn(gen, (S, heads, t1, D)))
        pad = pads if padded else None
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=t1,
                  sliding_window=sw, pad_len=pad)
        got = FE.flash_extend_attention_rows(*arrays, counts, **kw)
        want = FE.flash_extend_attention_rows_plain(*arrays, counts, **kw)
        torch.cuda.synchronize()
        rows = counts.tolist()
        what = (f"{name} bits={bits} vf={vf} Hkv={heads} r={r} T1={t1} "
                f"pads={padded} window={sw} counters {rows}")
        worst = max(worst, _rows_err(got, want, what, TOL.EXTEND_RTOL))
        for s_, (nkq, nkw, nvq) in enumerate(rows):
            one = FE.flash_extend_attention(
                *(a[s_:s_ + 1] for a in arrays), nkq, nkw, nvq,
                **dict(kw, pad_len=None if pad is None else pad[s_:s_ + 1]))
            if not torch.equal(one[0], got[s_]):
                raise AssertionError(f"{what}: row {s_} differs from the "
                                     "host-int entry at its counters")
        log(f"[kernel] {what}: every row bit-equal to the host-int entry "
            "launched alone at its counters")
        if timed is None:
            timed = (c, qcfg, counts, arrays, kw, want, t1)
    c, qcfg, counts, arrays, kw, want, t1 = timed
    # control: one row (fill 137) reads one more group of history
    s_ = FILLS.index(137)
    bad = counts.clone()
    bad[s_, 0] += 32
    ctrl = FE.flash_extend_attention_rows(*arrays, bad, **kw)
    _refused(TOL.row_share(ctrl[s_], want[s_], TOL.EXTEND_RTOL).max().item(),
             f"{name}: control that advances row {s_}'s n_k_quant by one "
             "group")
    rows = counts.tolist()
    sb = c.k_scale.element_size()
    q = arrays[0]
    T0 = [nkq + nkw for nkq, nkw, _ in rows]
    nbytes = (sum(H * _live_bytes(qcfg, sb, nkq, nkw, nvq, nkq + nkw - nvq)
                  for nkq, nkw, nvq in rows)
              + 3 * q.numel() * 2 + q.numel() * 4 + S * 3 * 4)
    pairs = sum(t1 * t0 + t1 * (t1 + 1) // 2 for t0 in T0)
    bms, by = bound(nbytes, 4 * H * D * pairs)
    # yardstick: SDPA over each row's history + window + new keys in bf16
    L = max(T0) + t1
    k = torch.zeros((S, H, L, D), dtype=torch.bfloat16, device="cuda")
    v = torch.zeros_like(k)
    k_deq = Q.dequantize_k(c.k_codes, c.k_scale, c.k_mn, 32,
                           2).transpose(-1, -2)
    v_deq = Q.dequantize_v(c.v_codes, c.v_scale, c.v_mn, 32, 2)
    kn, vn = arrays[9], arrays[10]
    mask = torch.zeros((S, 1, t1, L), dtype=torch.bool, device="cuda")
    for s_, (nkq, nkw, nvq) in enumerate(rows):
        t0, nvw = nkq + nkw, nkq + nkw - nvq
        k[s_, :, :nkq] = k_deq[s_, :, :nkq].to(torch.bfloat16)
        k[s_, :, nkq:t0] = c.k_win[s_, :, :nkw]
        v[s_, :, :nvq] = v_deq[s_, :, :nvq].to(torch.bfloat16)
        v[s_, :, nvq:t0] = c.v_win[s_, :, :nvw]
        k[s_, :, t0:t0 + t1] = kn[s_]
        v[s_, :, t0:t0 + t1] = vn[s_]
        mask[s_, 0] = (torch.arange(L, device="cuda")[None, :]
                       <= t0 + torch.arange(t1, device="cuda")[:, None])
    del k_deq, v_deq
    results[name] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: FE.flash_extend_attention_rows(*arrays, counts,
                                                          **kw)),
        plain_ms=cuda_ms(lambda: FE.flash_extend_attention_rows_plain(
            *arrays, counts, **kw)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)))
    log(f"[kernel] {name} timed at S={S} slots, fills {FILLS}, T1={t1}, "
        f"KIVI-2 (vf 128), H={H}: live bytes {nbytes / 1e6:.2f} MB")


def _logit_err(got, want, nq: int, what: str) -> float:
    """QK logits: positions >= nq exactly NEG_INF in both, the rest within
    the attention tolerance."""
    if not ((got[..., nq:] == NEG_INF).all()
            and (want[..., nq:] == NEG_INF).all()):
        raise AssertionError(f"{what}: positions >= n_quant are not masked")
    if nq == 0:
        log(f"[kernel] {what}: every position masked")
        return 0.0
    return _att_err(got[..., :nq], want[..., :nq], what)


def check_qk_pv(gen, results):
    """Rows 7 and 8 at the long slice's geometry (batch 1, 8 KV heads, a
    16K cache filled to 12K), bits 2/4/8, r 1/2/4/8, f32 scales, D = 64,
    n_quant 0, around the split (1, 255, 256, 257), inside a group and a
    split (5017), the cache's and all of T; each bit-equal across two
    runs; controls (PV without p's first split, QK against keys changed
    in the first split) refused; then timed at the slice's shapes.  The
    contract's other edges (group sizes 1 to 128, D not a multiple of 8)
    are tests/test_torch_kernels_cuda.py's."""
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.core import quant as Q
    from kivi_tpu_torch.kernels import qk_pv as QP
    S = QP.SPLIT
    worst = {"qk_dequant_matmul": 0.0, "pv_dequant_matmul": 0.0}
    pos = torch.arange(LTMAX, device="cuda")

    def softmax_p(r, nq):
        """p: a softmax over the first nq positions, exactly 0 past them."""
        p = torch.zeros((LB, LH, r, LTMAX), device="cuda")
        if nq:
            p = torch.softmax(torch.randn(
                p.shape, generator=gen, device="cuda").masked_fill(
                    pos >= nq, float("-inf")), dim=-1)
        return p

    timed = None
    for bits, r, sdt, d in ((2, 4, "bfloat16", D), (2, 1, "bfloat16", D),
                            (2, 8, "bfloat16", D), (2, 2, "bfloat16", D),
                            (4, 4, "bfloat16", D), (8, 4, "bfloat16", D),
                            (2, 4, "float32", D), (4, 4, "bfloat16", 64)):
        qcfg = QuantConfig(bits, bits, 32, 32, scale_dtype=sdt)
        c = _filled_cache(gen, qcfg, LFILL + 1, LH, LB, LTMAX, d)
        q = _randn(gen, (LB, LH, r, d))
        kargs = (c.k_codes, c.k_scale, c.k_mn, 32, bits)
        vargs = (c.v_codes, c.v_scale, c.v_mn, 32, bits)
        for nq in (0, 1, S - 1, S, S + 1, 5017, c.n_k_quant, LTMAX):
            what = f"bits={bits} r={r} {sdt} D={d} n_quant={nq}"
            want = QP.qk_dequant_matmul_plain(q, *kargs, n_quant=nq)
            got = _twice(lambda: QP.qk_dequant_matmul(q, *kargs, n_quant=nq),
                         f"qk_dequant_matmul {what}")
            worst["qk_dequant_matmul"] = max(
                worst["qk_dequant_matmul"],
                _logit_err(got, want, nq, f"qk_dequant_matmul {what} (two "
                                          "runs bit-equal)"))
            p = softmax_p(r, nq)
            got = _twice(lambda: QP.pv_dequant_matmul(p, *vargs, n_quant=nq),
                         f"pv_dequant_matmul {what}")
            want = QP.pv_dequant_matmul_plain(p, *vargs, n_quant=nq)
            worst["pv_dequant_matmul"] = max(
                worst["pv_dequant_matmul"],
                _att_err(got, want, f"pv_dequant_matmul {what} (two runs "
                                    "bit-equal)"))
        if (bits, r, sdt, d) == (2, LR, "bfloat16", D):
            timed = (c, q, kargs, vargs)

    c, q, kargs, vargs = timed
    nkq, nvq = c.n_k_quant, c.n_v_quant
    p = softmax_p(LR, nkq).masked_fill(pos >= nvq, 0.0)
    # controls: each must miss its plain version by more than the limit
    moved = c.k_codes.clone()
    moved[..., :S] ^= 0x55555555            # every code of the first split
    want = QP.qk_dequant_matmul_plain(q, moved, *kargs[1:], n_quant=nkq)
    _control_refused(QP.qk_dequant_matmul(q, *kargs, n_quant=nkq)[..., :nkq],
                     want[..., :nkq], "qk_dequant_matmul",
                     "against keys changed in the first split")
    cut = p.clone()
    cut[..., :S] = 0.0
    _control_refused(QP.pv_dequant_matmul(cut, *vargs, n_quant=nvq),
                     QP.pv_dequant_matmul_plain(p, *vargs, n_quant=nvq),
                     "pv_dequant_matmul", "without p's first split")
    # yardsticks: one torch.matmul over the stores dequantized to bf16
    k_deq = Q.dequantize_k(*kargs)[..., :nkq].to(torch.bfloat16).contiguous()
    v_deq = Q.dequantize_v(*vargs)[:, :, :nvq].to(torch.bfloat16).contiguous()
    p_b = p[..., :nvq].to(torch.bfloat16).contiguous()
    sb, kdw = c.k_scale.element_size(), D // 16
    qk_bytes = (LB * LH * (nkq * kdw * 4 + 2 * (nkq // 32) * D * sb)
                + q.numel() * 2 + LB * LH * LR * LTMAX * 4)
    pv_bytes = (LB * LH * (nvq * kdw * 4 + 2 * (D // 32) * nvq * sb)
                + LB * LH * LR * nvq * 4 + LB * LH * LR * D * 4)
    for name, fn, plain, lib, nbytes, n in (
            ("qk_dequant_matmul",
             lambda: QP.qk_dequant_matmul(q, *kargs, n_quant=nkq),
             lambda: QP.qk_dequant_matmul_plain(q, *kargs, n_quant=nkq),
             lambda: torch.matmul(q, k_deq), qk_bytes, nkq),
            ("pv_dequant_matmul",
             lambda: QP.pv_dequant_matmul(p, *vargs, n_quant=nvq),
             lambda: QP.pv_dequant_matmul_plain(p, *vargs, n_quant=nvq),
             lambda: torch.matmul(p_b, v_deq), pv_bytes, nvq)):
        bms, by = bound(nbytes, 2 * LB * LH * LR * n * D)
        results[name] = dict(max_abs_err=worst[name], ms=cuda_ms(fn),
                             plain_ms=cuda_ms(plain), bound_ms=bms,
                             bound_by=by, library_ms=cuda_ms(lib))
        log(f"[kernel] {name} timed at B={LB}, Hkv={LH}, r={LR}, n_quant "
            f"{n} of {LTMAX}, KIVI-2: {nbytes / 1e6:.2f} MB")


def _rows_err(got, want, what: str, rtol: float) -> float:
    """A tensor-core kernel's output against the plain one, each query
    row within rtol of its own largest value (utils.tolerance)."""
    err, share = TOL.check_rows(got, want, rtol, what)
    log(f"[kernel] {what}: max|kernel - plain| = {err:.3e}, worst row at "
        f"{share:.3f} of its limit (rtol {rtol:.4g} of the row's max)")
    return err


def _state_err(got, want, what: str) -> float:
    """A flash state (acc, m, l) against the plain one: rows with no
    admitted position are (0, NEG_INF, 0) in both; the rest per row
    within QHIST_RTOL (utils.tolerance.check_state)."""
    err, share, empty = TOL.check_state(got, want, TOL.QHIST_RTOL, what)
    log(f"[kernel] {what}: max|acc - plain| = {err:.3e}, worst row at "
        f"{share:.3f} of its limit; {empty} rows see no history, exactly "
        "(0, -1e30, 0)")
    return err


def _refused(share: float, what: str) -> None:
    """A control that must fail the check: its worst share > 1."""
    if share <= 1:
        raise AssertionError(f"{what}: the check passed a control ({share:.3f}"
                             " of the limit)")
    log(f"[kernel] {what}: refused, worst row at {share:.1f} of its limit")


def check_qhist(gen, results):
    """Row 5 against its plain version: the slice's geometry, an empty
    history, bits 2/4/8, n_k_quant > n_v_quant, per-row pads (one past
    the history), a sliding window and the prefix paths' batch-1 suffix
    behind the 2304-token snapshot; timed at the slice's shapes."""
    import torch.nn.functional as F

    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.kernels import flash_extend as FE
    name = "flash_extend_qhist"
    worst, timed = 0.0, None
    # (history, pads, sliding window, bits, W, v_flush); the slice's
    # geometry (LH KV heads, r LR, T1, LTMAX) but where named
    slice_geo = dict(heads=LH, r=LR, t1=T1, tmax=LTMAX)
    cases = [(LFILL, None, 0, 2, 32, 32, {}),        # the slice
             (0, None, 0, 2, 32, 32, {}),            # empty history
             (3000, None, 0, 4, 32, 32, {}), (3000, None, 0, 8, 32, 32, {}),
             (2200, None, 0, 2, 128, 32, {}),        # n_k_quant > n_v_quant
             (3000, (0, 700), 0, 2, 32, 32, {}),
             (3000, (32, 3050), 0, 2, 32, 32, {}),   # row 1 sees nothing
             (3000, None, 1000, 4, 32, 32, {}),      # sliding window
             # the prefix-qhist path: Llama-2-7B's heads behind the
             # 2304-token snapshot, the 96-token suffix at batch 1
             (PREFIX_LONG, None, 0, 2, 128, 128,
              dict(heads=H, r=1, t1=SUFFIX, tmax=TMAX))]
    for fill, pads, sw, bits, W, vf, geo in cases:
        geo = {**slice_geo, **geo}
        qcfg = QuantConfig(bits, bits, 32, W, v_flush=vf)
        batch = 1 if pads is None else len(pads)
        c = _ingested_cache(gen, qcfg, fill, heads=geo["heads"], batch=batch,
                            tmax=geo["tmax"])
        qg = _randn(gen, (batch, geo["heads"], geo["r"] * geo["t1"], D))
        pad_len = (None if pads is None else
                   torch.tensor(pads, device="cuda", dtype=torch.int32))
        args = (qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.v_win, c.n_k_quant, c.n_v_quant, c.seq_len)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=geo["t1"],
                  sliding_window=sw, pad_len=pad_len)
        got = FE.flash_extend_qhist(*args, **kw)
        want = FE.flash_extend_qhist_plain(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _state_err(
            got, want, f"{name} history={fill} pads={pads} window={sw} "
                       f"bits={bits} W={W} vf={vf} Hkv={geo['heads']} "
                       f"r={geo['r']} T1={geo['t1']} (nkq={c.n_k_quant} "
                       f"nvq={c.n_v_quant})"))
        if fill == LFILL:
            timed = (c, qcfg, args, kw, qg)
            # control: the kernel's own state without the history's first
            # 64-position chunk (the kernel at a left pad of 64)
            ctrl = FE.flash_extend_qhist(*args, **dict(kw, pad_len=torch.full(
                (1,), 64, device="cuda", dtype=torch.int32)))
            _refused(max(TOL.state_shares(ctrl, want, TOL.QHIST_RTOL)
                         .values()), f"{name} history={fill}: control that "
                     "skips the first 64-position chunk")
    c, qcfg, args, kw, qg = timed
    nkq, nvq = c.n_k_quant, c.n_v_quant
    k, v = _deq_kv(c, qcfg, nkq)
    sb, kdw = c.k_scale.element_size(), D // 16
    R = LR * T1
    nbytes = (LB * LH * (nkq * kdw * 4 + 2 * (nkq // 32) * D * sb
                         + nvq * kdw * 4 + 2 * (D // 32) * nvq * sb
                         + (nkq - nvq) * D * 2)
              + qg.numel() * 2 + LB * LH * R * (D + 2) * 4)
    bms, by = bound(nbytes, 4 * LB * LH * R * nkq * D)
    results[name] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: FE.flash_extend_qhist(*args, **kw)),
        plain_ms=cuda_ms(lambda: FE.flash_extend_qhist_plain(*args, **kw)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qg, k, v)))
    log(f"[kernel] {name} timed at B={LB}, Hkv={LH}, R={R} rows (r={LR}, "
        f"T1={T1}), history {nkq} of {LTMAX}, KIVI-2")


def check_split_routes(gen, crossover: list):
    """The split routes against the fused kernels on the same inputs, and
    the fused kernels against their plain versions, at the long slice's
    geometry with W = 32, v_flush = 32 (the reference's example
    configuration), left pad 32; both timed at each of CROSS_FILLS.
    Decode: the split route (qk_dequant_matmul, torch softmax,
    pv_dequant_matmul) vs fused_decode_attention_wide, and row 6
    (fused_decode_attention: per-row counters under the t_bound that the
    long slice's replayed decode passes it) vs its plain version and vs
    the split route; the three compute one function in f32 (ATT_RTOL).
    Extend (T1 = 128): the qhist route
    (flash_extend_qhist + torch merge) and flash_extend_attention each
    against flash_extend_attention_plain, per query row: both round
    their operands to bf16, so neither is the other's reference; the
    route at QHIST_RTOL, the fused kernel at EXTEND_RTOL."""
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.core import attention as TA
    from kivi_tpu_torch.kernels import flash_extend as FE
    from kivi_tpu_torch.kernels import fused_decode as FR
    from kivi_tpu_torch.kernels import fused_decode_wide as FD
    from kivi_tpu_torch.serving.engine import fill_bound
    qcfg = QuantConfig(2, 2, 32, 32)
    pad = torch.full((LB,), LPAD, device="cuda", dtype=torch.int32)
    tb = TA.t_bound_for(fill_bound(LFILL, LNEW - 1), LTMAX,
                        qcfg.residual_length)
    for fill in CROSS_FILLS:
        c = _filled_cache(gen, qcfg, fill + 1, LH, LB, LTMAX)
        q = _randn(gen, (LB, LH, LR, D))
        args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.k_win, c.v_win, c.n_k_quant, c.n_k_win,
                c.n_v_quant)
        kw = dict(group_size=32, k_bits=2, v_bits=2, lo=pad)
        fused = FD.fused_decode_attention_wide(*args, **kw)
        plain = FD.fused_decode_attention_wide_plain(*args, **kw)
        split = TA._decode_attention_split(q, c, qcfg, pad)
        torch.cuda.synchronize()
        geo = f"W=32 vf=32 B={LB} Hkv={LH} r={LR} pad={LPAD}"
        _att_err(fused, plain, f"fused_decode_attention_wide {geo} fill="
                               f"{c.seq_len} vs its plain version")
        _att_err(split, fused, f"split decode route vs fused_decode_"
                               f"attention_wide, {geo} fill={c.seq_len}")
        counts = torch.tensor([[c.n_k_quant, c.n_k_win, c.n_v_quant]] * LB,
                              device="cuda", dtype=torch.int32)
        rargs = args[:9] + (counts,)
        rkw = dict(kw, t_bound=tb)
        rows = FR.fused_decode_attention(*rargs, **rkw)
        rplain = FR.fused_decode_attention_plain(*rargs, **rkw)
        torch.cuda.synchronize()
        _att_err(rows, rplain, f"fused_decode_attention {geo} fill="
                               f"{c.seq_len} t_bound={tb} vs its plain "
                               "version")
        _att_err(split, rows, f"split decode route vs fused_decode_"
                              f"attention {geo} fill={c.seq_len} "
                              f"t_bound={tb}")
        # the crossover is set by the routes' host launches: timed as a
        # host-bound caller sees them (no hold)
        dec = (cuda_ms(lambda: FD.fused_decode_attention_wide(*args, **kw),
                       hold=False),
               cuda_ms(lambda: TA._decode_attention_split(q, c, qcfg, pad),
                       hold=False),
               cuda_ms(lambda: FR.fused_decode_attention(*rargs, **rkw),
                       hold=False))

        ce = _ingested_cache(gen, qcfg, fill)
        qe = _randn(gen, (LB, LH, LR * T1, D))
        kn, vn = _randn(gen, (LB, LH, T1, D)), _randn(gen, (LB, LH, T1, D))
        eargs = (qe, ce.k_codes, ce.k_scale, ce.k_mn, ce.v_codes,
                 ce.v_scale, ce.v_mn, ce.k_win, ce.v_win, kn, vn,
                 ce.n_k_quant, ce.n_k_win, ce.n_v_quant)
        ekw = dict(group_size=32, k_bits=2, v_bits=2, t1=T1,
                   sliding_window=0, pad_len=pad)

        def qhist_route():
            return TA._extend_attention_qhist(
                qe.reshape(LB, LH, LR, T1, D), kn, vn, ce, qcfg,
                sliding_window=None, pad_len=pad)

        full = FE.flash_extend_attention(*eargs, **ekw)
        eplain = FE.flash_extend_attention_plain(*eargs, **ekw)
        routed = qhist_route().reshape(full.shape)
        torch.cuda.synchronize()
        _rows_err(full, eplain, f"flash_extend_attention {geo} T1={T1} "
                                f"history={fill} vs its plain version",
                  TOL.EXTEND_RTOL)
        _rows_err(routed, eplain, f"qhist extend route vs flash_extend_"
                                  f"attention_plain, {geo} T1={T1} "
                                  f"history={fill}", TOL.QHIST_RTOL)
        ext = (cuda_ms(lambda: FE.flash_extend_attention(*eargs, **ekw),
                       hold=False),
               cuda_ms(qhist_route, hold=False))
        crossover.append(dict(fill=fill, decode_fused_ms=dec[0],
                              decode_split_ms=dec[1], decode_rows_ms=dec[2],
                              t_bound=tb, extend_fused_ms=ext[0],
                              extend_split_ms=ext[1]))
        log(f"[crossover] history {fill}: decode fused {dec[0]:.4f} ms, "
            f"split {dec[1]:.4f} ms, row 6 (t_bound {tb}) {dec[2]:.4f} ms "
            f"| extend (T1={T1}) fused {ext[0]:.4f} "
            f"ms, qhist {ext[1]:.4f} ms | SPLIT_MIN_HISTORY "
            f"{TA.SPLIT_MIN_HISTORY}")
        del c, ce


def check_trimmed(results):
    """Row 11, the decode ablation probe, by the profiler's own checker
    (profile_wide_32k.check) on its uniform cache and on a peaked one
    (keys and values quantized from N(0, 1)): every variant
    (trimmed.VARIANTS) against its plain version, bit-equal across two
    runs; the attention variants (full, fold) also against the plain
    decode at an empty window; the wide kernel and the decode route
    core.attention picks (split) against the plain decode with the
    window.  At bits 2/4, r 1/4, fill partial and full (B = 2, 8 KV
    heads, a 4K cache), then at the probe path's own 32K geometry
    (B = 4, 32 KV heads, fill 32,640, KIVI-2), whose uniform cache is
    the one the probe path times; there the full variant is timed."""
    import torch.nn.functional as F

    from kivi_tpu_torch import profile_wide_32k as PW
    from kivi_tpu_torch.core import quant as Q
    from kivi_tpu_torch.kernels import trimmed as TR
    name = "trimmed"
    tol = dict(rtol=ATT_RTOL, atol=ATT_ATOL)
    worst = 0.0
    for bits in (2, 4):
        for r in (1, 4):
            for fill in (2500, 4096):
                for data in PW.DATA:
                    worst = max(worst, PW.check(*PW.make_cache(
                        2, 4096, fill, heads=8, r=r, bits=bits,
                        seed=bits + r, data=data), what=f"{data} ", **tol))
    B4, T4, F4 = 4, 32768, 32640
    for data in PW.DATA[::-1]:          # the profiler's uniform cache last
        qg, c = PW.make_cache(B4, T4, F4, data=data)
        worst = max(worst, PW.check(qg, c, what=f"{data} ", **tol))
    args = (qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            F4)
    kw = dict(group_size=32, k_bits=2, v_bits=2)
    k = Q.dequantize_k(c.k_codes, c.k_scale, c.k_mn, 32, 2)[..., :F4]
    k = k.transpose(-1, -2).to(torch.bfloat16).contiguous()
    v = Q.dequantize_v(c.v_codes, c.v_scale, c.v_mn, 32, 2)[:, :, :F4]
    v = v.to(torch.bfloat16).contiguous()
    bms, by = PW.attention_bound(qg, c, F4, 0)
    results[name] = dict(
        max_abs_err=worst, ms=cuda_ms(lambda: TR.trimmed(*args, **kw)),
        plain_ms=cuda_ms(lambda: TR.trimmed_plain(*args, **kw)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qg, k, v)))
    log(f"[kernel] {name} (full variant) timed at B={B4}, Hkv={PW.HKV}, r=1,"
        f" fill {F4} of {T4}, KIVI-2")
    del k, v, c
    torch.cuda.empty_cache()


def check_flash(gen, results):
    import torch.nn.functional as F

    from kivi_tpu_torch.kernels import flash as FL
    name = "flash_attention"
    T = 1024
    worst = 0.0
    # (T, KV heads, sliding window, pad); the main path runs the first
    cases = [(T, H, None, None), (1000, H, None, None), (T, 8, None, None),
             (T, H, 256, None), (T, H, None, "arange"),
             (T, H, None, "last")]
    timed = None
    for t, heads, sw, pad in cases:
        q = _randn(gen, (B, H, t, D))
        k, v = _randn(gen, (B, heads, t, D)), _randn(gen, (B, heads, t, D))
        pad_len = None
        if pad == "arange":
            pad_len = torch.arange(B, device="cuda", dtype=torch.int32) * 37
        elif pad == "last":                 # row 0 padded to t - 1
            pad_len = torch.zeros(B, device="cuda", dtype=torch.int32)
            pad_len[0] = t - 1
        kw = dict(sliding_window=sw, pad_len=pad_len)
        got = FL.flash_attention(q, k, v, **kw)
        want = FL.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: output {got.dtype}, not bf16")
        what = f"{name} T={t} Hkv={heads} window={sw} pad={pad}"
        worst = max(worst, _rows_err(got, want, what, TOL.FLASH_RTOL))
        if pad_len is not None:
            # padded query rows (t < pad) come out exactly 0
            rows = torch.arange(t, device="cuda")[None, :] < pad_len[:, None]
            if got.float().abs().amax(dim=(1, 3))[rows].max() != 0:
                raise AssertionError(f"{what}: padded rows are not 0")
            log(f"[kernel] {what}: {int(rows.sum())} padded query rows "
                f"x {H} heads exactly 0")
        if pad == "last":
            # the one live row of row 0 attends itself alone
            err_v = (got[0, :, -1].float() - v[0, :, -1].float()).abs().max()
            if err_v > 2.0 ** -8 * v.abs().max():
                raise AssertionError(f"{what}: last row != its own V")
        if (t, heads, sw, pad) == (T, H, None, None):
            timed = (q, k, v, got, want)
    q, k, v, got, want = timed
    # control: the last 128 rows without their first 128-key chunk (taken
    # from the kernel itself at a left pad of 128)
    ctrl = got.clone()
    ctrl[:, :, -128:] = FL.flash_attention(q, k, v, pad_len=torch.full(
        (B,), 128, device="cuda", dtype=torch.int32))[:, :, -128:]
    _refused(TOL.row_share(ctrl, want, TOL.FLASH_RTOL).max().item(),
             f"{name} T={T}: control that skips the first chunk in the "
             "last 128 rows")
    nbytes = 4 * q.numel() * 2                       # q, k, v, out bf16
    bms, by = bound(nbytes, 4 * B * H * D * T * (T + 1) // 2)
    results[name] = dict(
        max_abs_err=worst, ms=cuda_ms(lambda: FL.flash_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: FL.flash_attention_plain(q, k, v)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)))
    log(f"[kernel] {name} timed at B={B}, H={H}, T={T}, D={D}, causal")


def check_wgmma_tile(gen):
    """The tensor-core tile of csrc/attn_wgmma.cuh alone, every shape the
    two kernels use, against torch.matmul (TF32 off): exact bf16 products
    summed in f32 in another order, so ATT_RTOL."""
    from kivi_tpu_torch.kernels import flash as FL
    for mode, n in (("qk", 16), ("qk", 64), ("qk", 128), ("pv", 64),
                    ("pv", 128)):
        a = _randn(gen, (64, D if mode == "qk" else n))
        b = _randn(gen, (n, D))
        got = FL.wgmma_tile(a, b, mode)
        torch.cuda.synchronize()
        _att_err(got, FL.wgmma_tile_plain(a, b, mode),
                 f"wgmma tile {mode} n={n}")


def check_fp_decode(gen, results):
    import torch.nn.functional as F

    from kivi_tpu_torch.cache import fp_cache as FC
    from kivi_tpu_torch.kernels import fp_decode as FD
    name = "fp_decode_attention_kernel"
    worst = 0.0
    S = FD.SPLIT
    # (fill, KV heads, query rows per KV head, mask): fills at the edges
    # of the kernel's splits too
    cases = [(fill, H, 1, None) for fill in (1, S - 1, S, S + 1, 1081,
                                             TMAX)]
    cases += [(1081, 8, 4, None), (1081, H, 1, "pad"), (1081, H, 1, "swa"),
              (TMAX, 8, 4, "swa")]         # splits from the window's bound
    timed = None
    for fill, heads, r, mask in cases:
        c = FC.init_fp_cache(B, heads, D, TMAX, device="cuda")
        # the whole buffer random: positions past `length` must not count
        c.k.copy_(_randn(gen, c.k.shape))
        c.v.copy_(_randn(gen, c.v.shape))
        c.length = fill
        q = _randn(gen, (B, heads, r, D))
        kw = {}
        if mask == "pad":
            kw["pad_len"] = torch.arange(B, device="cuda",
                                         dtype=torch.int32) * 37
        elif mask == "swa":
            kw["sliding_window"] = 1000
        got = FD.fp_decode_attention_kernel(q, c.k, c.v, fill, **kw)
        want = FD.fp_decode_attention_plain(q, c.k, c.v, fill, **kw)
        again = FD.fp_decode_attention_kernel(q, c.k, c.v, fill, **kw)
        torch.cuda.synchronize()
        what = f"{name} fill={fill} Hkv={heads} r={r} mask={mask}"
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two runs differ")
        worst = max(worst, _att_err(got, want, f"{what} (two runs "
                                               "bit-equal)"))
        if (fill, r, mask) == (1081, 1, None):
            timed = (c, q)
    # per-row lengths (the continuous batcher's slot caches): each row
    # at its own fill, 0 for an empty slot; the window counts back from
    # each row's own length
    S = len(FILLS)
    lens = torch.tensor(FILLS, device="cuda", dtype=torch.int32)
    for heads, r, mask in ((H, 1, None), (8, 4, "pad"), (H, 1, "swa")):
        c = FC.init_fp_slot_cache(S, heads, D, TMAX, device="cuda")
        c.k.copy_(_randn(gen, c.k.shape))
        c.v.copy_(_randn(gen, c.v.shape))
        c.length.copy_(lens)
        q = _randn(gen, (S, heads, r, D))
        kw = {}
        if mask == "pad":
            kw["pad_len"] = torch.tensor([0, 0, 37, 300, 1000, 5, 3999, 0],
                                         device="cuda", dtype=torch.int32)
        elif mask == "swa":
            kw["sliding_window"] = 1000
        got = FD.fp_decode_attention_kernel(q, c.k, c.v, c.length, **kw)
        want = FD.fp_decode_attention_plain(q, c.k, c.v, c.length, **kw)
        again = FD.fp_decode_attention_kernel(q, c.k, c.v, c.length, **kw)
        torch.cuda.synchronize()
        what = (f"{name} per-row lengths {FILLS} Hkv={heads} r={r} "
                f"mask={mask}")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two runs differ")
        worst = max(worst, _att_err(got, want, f"{what} (two runs "
                                               "bit-equal)"))
        if got[FILLS.index(0)].abs().max() != 0:
            raise AssertionError(f"{what}: the empty row is not 0")
        if (heads, mask) == (H, None):
            rows = (c, q)
    c_rows, q_rows = rows
    rows_bytes = (2 * H * sum(FILLS) * D * 2 + q_rows.numel() * 2
                  + q_rows.numel() * 4 + S * 4)
    rows_bms, _ = bound(rows_bytes, 4 * H * sum(FILLS) * D)
    rows_ms = cuda_ms(lambda: FD.fp_decode_attention_kernel(
        q_rows, c_rows.k, c_rows.v, c_rows.length))
    # yardstick: SDPA over the live K/V of the longest fill, a per-row
    # boolean mask
    L = max(FILLS)
    k_rows = c_rows.k[..., :L].transpose(-1, -2).contiguous()
    v_rows = c_rows.v[:, :, :L].contiguous()
    rmask = (torch.arange(L, device="cuda")[None, :]
             < lens[:, None])[:, None, None]
    rows_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q_rows, k_rows, v_rows, attn_mask=rmask))
    log(f"[kernel] {name} per-row lengths {FILLS}: {rows_ms:.4f} ms, bound "
        f"{rows_bms:.4f} ms, library (SDPA, per-row mask) {rows_lib:.4f} ms")
    del c_rows, rows, k_rows, v_rows

    c, q = timed
    fill = c.length
    k = c.k[..., :fill].transpose(-1, -2).contiguous()   # (B, H, T, D)
    v = c.v[:, :, :fill].contiguous()
    nbytes = 2 * B * H * fill * D * 2 + q.numel() * 2 + q.numel() * 4
    bms, by = bound(nbytes, 4 * B * H * fill * D)
    results[name] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: FD.fp_decode_attention_kernel(q, c.k, c.v,
                                                         fill)),
        plain_ms=cuda_ms(lambda: FD.fp_decode_attention_plain(q, c.k, c.v,
                                                              fill)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        rows_ms=rows_ms, rows_bound_ms=rows_bms, rows_library_ms=rows_lib)
    log(f"[kernel] {name} timed at fill {fill}, B={B}, H={H}, r=1")


# per-slot fills of the fill-bound checks: the batcher's and the engine's
# (prompts up to 1024, up to 128 new tokens), under the bound 1536 that
# the engine's chunked path and the batcher's steps run with
BOUND_FILLS = (129, 256, 300, 512, 640, 1024, 1100, 0)
FILL_BOUND = 1536


def check_t_bound(gen, results):
    """Rows 6 and 9 under the static fill bound (t_bound) that a replayed
    decode step passes them, at BOUND_FILLS in a 4096-token cache: within
    the tolerance of their plain versions under the bound, bit-equal to
    the full grid (the contract holds), two runs bit-equal, beside a row
    past the bound that the bound truncates as the plain version does;
    timed beside the full grid."""
    from kivi_tpu_torch.cache import fp_cache as FC
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.core.attention import t_bound_for
    from kivi_tpu_torch.kernels import fp_decode as FD
    from kivi_tpu_torch.kernels import fused_decode as FR
    kivi = QuantConfig(2, 2, 32, 128, v_flush=128)
    tb = t_bound_for(FILL_BOUND, TMAX, kivi.residual_length)
    S = len(BOUND_FILLS)

    c = _slot_cache(gen, kivi, H, fills=BOUND_FILLS)
    q = _randn(gen, (S, H, 1, D))
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win, counts)
    kw = dict(group_size=32, k_bits=2, v_bits=2)
    what = f"fused_decode_attention t_bound={tb} fills={BOUND_FILLS}"
    got = _twice(lambda: FR.fused_decode_attention(*args, t_bound=tb, **kw),
                 what)
    err = _att_err(got, FR.fused_decode_attention_plain(
        *args, t_bound=tb, **kw), what + " (two runs bit-equal)")
    if not torch.equal(got, FR.fused_decode_attention(*args, **kw)):
        raise AssertionError(f"{what}: differs from the full grid")
    rows = _row_counts(c)
    sb = c.k_scale.element_size()
    bms, by = bound(sum(H * _live_bytes(kivi, sb, *x) for x in rows)
                    + q.numel() * 2 + S * H * D * 4 + S * 3 * 4,
                    4 * H * D * sum(BOUND_FILLS))
    past = torch.tensor([[2048, 0, 2048]] * S, device="cuda",
                        dtype=torch.int32)     # live past the bound
    cut = args[:-1] + (past,)
    _att_err(FR.fused_decode_attention(*cut, t_bound=tb, **kw),
             FR.fused_decode_attention_plain(*cut, t_bound=tb, **kw),
             what + " truncating a row past the bound")
    results["fused_decode_attention"]["t_bound"] = dict(
        fills=list(BOUND_FILLS), t_bound=tb, max_abs_err=err,
        bound_ms=bms, bound_by=by,
        ms=cuda_ms(lambda: FR.fused_decode_attention(*args, t_bound=tb,
                                                     **kw)),
        full_grid_ms=cuda_ms(lambda: FR.fused_decode_attention(*args,
                                                               **kw)),
        plain_ms=cuda_ms(lambda: FR.fused_decode_attention_plain(
            *args, t_bound=tb, **kw)))
    del c

    tb = t_bound_for(FILL_BOUND, TMAX)
    c = FC.init_fp_slot_cache(S, H, D, TMAX, device="cuda")
    c.k.copy_(_randn(gen, c.k.shape))
    c.v.copy_(_randn(gen, c.v.shape))
    c.length.copy_(torch.tensor(BOUND_FILLS, device="cuda"))
    what = f"fp_decode_attention_kernel t_bound={tb} fills={BOUND_FILLS}"
    got = _twice(lambda: FD.fp_decode_attention_kernel(
        q, c.k, c.v, c.length, t_bound=tb), what)
    err = _att_err(got, FD.fp_decode_attention_plain(
        q, c.k, c.v, c.length, t_bound=tb), what + " (two runs bit-equal)")
    if not torch.equal(got, FD.fp_decode_attention_kernel(q, c.k, c.v,
                                                          c.length)):
        raise AssertionError(f"{what}: differs from the full grid")
    past = torch.full((S,), 3000, device="cuda", dtype=torch.int32)
    _att_err(FD.fp_decode_attention_kernel(q, c.k, c.v, past, t_bound=tb,
                                           sliding_window=1500),
             FD.fp_decode_attention_plain(q, c.k, c.v, past, t_bound=tb,
                                          sliding_window=1500),
             what + " truncating rows past the bound")
    bms, by = bound(2 * H * sum(BOUND_FILLS) * D * 2 + q.numel() * 6
                    + S * 4, 4 * H * sum(BOUND_FILLS) * D)
    results["fp_decode_attention_kernel"]["t_bound"] = dict(
        fills=list(BOUND_FILLS), t_bound=tb, max_abs_err=err,
        bound_ms=bms, bound_by=by,
        ms=cuda_ms(lambda: FD.fp_decode_attention_kernel(
            q, c.k, c.v, c.length, t_bound=tb)),
        full_grid_ms=cuda_ms(lambda: FD.fp_decode_attention_kernel(
            q, c.k, c.v, c.length)),
        plain_ms=cuda_ms(lambda: FD.fp_decode_attention_plain(
            q, c.k, c.v, c.length, t_bound=tb)))
    for name in ("fused_decode_attention", "fp_decode_attention_kernel"):
        r = results[name]["t_bound"]
        log(f"[kernel] {name} at fills {BOUND_FILLS}: t_bound {r['t_bound']}"
            f" {r['ms']:.4f} ms, full grid {r['full_grid_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max err {r['max_abs_err']:.3g}")


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    check_quant(gen, results)
    check_decode(gen, results)
    check_fused_decode_rows(gen, results)
    check_extend(gen, results)
    check_extend_rows(gen, results)
    check_wgmma_tile(gen)
    check_flash(gen, results)
    check_fp_decode(gen, results)
    check_t_bound(gen, results)
    check_qk_pv(gen, results)
    check_qhist(gen, results)
    check_trimmed(results)
    crossover = []
    check_split_routes(gen, crossover)
    return results, crossover


# ---------------------------------------------------------------------------
# phase 4: the paths at full width
# ---------------------------------------------------------------------------

SPLIT_KERNELS = ("qk_dequant_matmul", "pv_dequant_matmul",
                 "flash_extend_qhist")
KIVI_KERNELS = ("quantize_pack_k", "quantize_pack_v", "flash_extend_attention",
                "flash_extend_attention_rows", "fused_decode_attention_wide",
                "fused_decode_attention") + SPLIT_KERNELS
PROBE = ("trimmed",)        # the ablation probe runs on the probe path only
# path -> (kernels that must launch, kernels that must not).  The engine's
# decode replays CUDA graphs over device counters (row 6, or the fp
# kernel's per-row entry); "-debug" is Engine(debug=True), the same step
# run eagerly as a checked call, so the same kernels; "long-split" is
# Engine.decode_step over host-int counters, the split decode route
PATHS = {
    "chunked": (("quantize_pack_k", "quantize_pack_v",
                 "flash_extend_attention", "fused_decode_attention"),
                ("fused_decode_attention_wide",) + SPLIT_KERNELS + PROBE),
    "oneshot": (("flash_attention", "quantize_pack_k", "quantize_pack_v",
                 "fused_decode_attention"),
                ("fused_decode_attention_wide",) + SPLIT_KERNELS + PROBE),
    "fp16": (("flash_attention", "fp_decode_attention_kernel"),
             KIVI_KERNELS + PROBE),
    "batcher": (("flash_attention", "quantize_pack_k", "quantize_pack_v",
                 "fused_decode_attention"),
                ("fused_decode_attention_wide", "flash_extend_attention",
                 "fp_decode_attention_kernel") + SPLIT_KERNELS + PROBE),
    "batcher-chunked": (("flash_extend_attention", "quantize_pack_k",
                         "quantize_pack_v", "fused_decode_attention"),
                        ("fused_decode_attention_wide", "flash_attention",
                         "fp_decode_attention_kernel") + SPLIT_KERNELS
                        + PROBE),
    "batcher-fp16": (("flash_attention", "fp_decode_attention_kernel"),
                     KIVI_KERNELS + PROBE),
    "long": (("quantize_pack_k", "quantize_pack_v", "flash_extend_qhist",
              "fused_decode_attention"),
             ("fused_decode_attention_wide", "qk_dequant_matmul",
              "pv_dequant_matmul", "fp_decode_attention_kernel",
              "flash_attention") + PROBE),
    "long-split": (("quantize_pack_v", "qk_dequant_matmul",
                    "pv_dequant_matmul"),
                   ("fused_decode_attention_wide", "fused_decode_attention",
                    "fp_decode_attention_kernel", "flash_attention",
                    "flash_extend_attention", "flash_extend_qhist")
                   + PROBE),
    # the 32K ablation profiler: the wide kernel and the split decode
    # route as anchors, then every variant of the probe
    "probe": (PROBE + ("fused_decode_attention_wide", "qk_dequant_matmul",
                       "pv_dequant_matmul"),
              ("quantize_pack_k", "quantize_pack_v", "flash_extend_attention",
               "fused_decode_attention", "flash_extend_qhist",
               "flash_attention", "fp_decode_attention_kernel")),
}
# the prefix slice (phase_prefix): each path's counts include what it
# runs of the snapshot's making (prefill_prefix one-shot: row 10)
_NOT_SPLIT = ("fused_decode_attention_wide", "qk_dequant_matmul",
              "pv_dequant_matmul", "fp_decode_attention_kernel") + PROBE
_PREFIX_RUN = ("quantize_pack_k", "quantize_pack_v", "flash_extend_attention",
               "fused_decode_attention")
PATHS.update({
    "prefix": (_PREFIX_RUN + ("flash_attention",),
               _NOT_SPLIT + ("flash_extend_qhist",)),
    "prefix-ragged": (_PREFIX_RUN, _NOT_SPLIT + ("flash_extend_qhist",
                                                 "flash_attention")),
    "prefix-stream": (_PREFIX_RUN, _NOT_SPLIT + ("flash_extend_qhist",
                                                 "flash_attention")),
    "prefix-extend": (_PREFIX_RUN, _NOT_SPLIT + ("flash_extend_qhist",
                                                 "flash_attention")),
    "prefix-qhist": (_PREFIX_RUN + ("flash_attention", "flash_extend_qhist"),
                     _NOT_SPLIT),
    "prefix-load": (_PREFIX_RUN, _NOT_SPLIT + ("flash_extend_qhist",
                                               "flash_attention")),
    "prefix-fp16": (("flash_attention", "fp_decode_attention_kernel"),
                    KIVI_KERNELS + PROBE),
    "beam": (("flash_attention", "quantize_pack_k", "quantize_pack_v",
              "fused_decode_attention"),
             _NOT_SPLIT + ("flash_extend_qhist", "flash_extend_attention")),
    "beam-prefix": (_PREFIX_RUN, _NOT_SPLIT + ("flash_extend_qhist",
                                               "flash_attention")),
    "batcher-prefix": (_PREFIX_RUN + ("flash_attention",),
                       _NOT_SPLIT + ("flash_extend_qhist",)),
})
PATHS.update({f"{p}-debug": PATHS[p]
              for p in ("chunked", "oneshot", "fp16", "long", "prefix",
                        "prefix-ragged", "prefix-stream", "prefix-extend",
                        "prefix-qhist", "prefix-load", "prefix-fp16", "beam",
                        "beam-prefix")})
DEBUG_NEW = 32     # tokens of each engine path's debug=True run
SPLIT_STEPS = 32   # host-int decode steps of the long slice's split route
PROFILED = 8       # decode steps under the profiler, per mode
DECODE = {}        # path -> mode -> decode measurements (phase 4)


def check_launches(path: str, launches: dict) -> None:
    must, must_not = PATHS[path]
    for k in must:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{path} path never launched {k}")
    for k in must_not:
        if launches.get(k, 0):
            raise AssertionError(f"{path} path launched {k}")


def busy_ms(what: str, fn) -> tuple:
    """(device busy ms, host wall ms) of fn() under torch.profiler: busy
    is the union of kernel and copy intervals, those of a graph's replay
    included; the wall runs from the call to the synchronize after it."""
    from torch.profiler import ProfilerActivity, profile

    from kivi_tpu_torch.profile_main_path import busy_span_us, device_events
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return busy_span_us(device_events(what, prof))[0] / 1e3, wall


def record_decode(path: str, mode: str, rows: int, steps: int,
                  wall_s: float, profiled: tuple, profiled_steps: int,
                  smi: str) -> None:
    """Decode tokens/s and host ms a step of a timed window without the
    profiler; device busy ms a step and the idle share 1 - busy / wall of
    the profiled_steps steps that follow it, both read from those steps
    (profiled = busy_ms(...)).  The profiler's own host cost stretches
    that wall a little, so the share leans high."""
    host = wall_s / steps * 1e3
    busy, pwall = profiled
    dev, idle = busy / profiled_steps, 1 - busy / pwall
    DECODE.setdefault(path, {})[mode] = dict(
        tokens_per_s=rows * steps / wall_s, host_ms_per_step=host,
        busy_ms_per_step=dev, profiled_host_ms_per_step=pwall / profiled_steps,
        idle_share=idle, steps=steps)
    log(f"[decode:{path}] {mode}: {rows * steps / wall_s:.1f} tokens/s, "
        f"host {host:.3f} ms a step | profiled: host "
        f"{pwall / profiled_steps:.3f} ms a step, device busy {dev:.3f} ms "
        f"a step, idle share {idle:.4f} | card {smi}")


def _prefill(eng, tokens, chunk, pad_lens):
    """Greedy first token and caches: into the engine's own caches."""
    caches = eng.own_caches()
    if chunk is None:
        return eng.prefill(tokens, caches, pad_lens)
    logits, caches = eng.prefill_chunked(tokens, chunk, caches, pad_lens)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    return logits.argmax(-1).to(torch.int32)[:, None], caches


def _timed_decode(path, mode, eng, tokens, steps, smi, chunk, pad_lens):
    """Prefill, then `steps` decode steps timed, then PROFILED more steps
    from where they ended under the profiler.  Returns (first token and
    the timed steps' tokens (B, steps + 1), caches, the next token's
    position)."""
    Bn, prompt = tokens.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, caches = _prefill(eng, tokens, chunk, pad_lens)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pos = torch.full((Bn, 1), prompt, device="cuda")
    if pad_lens is not None:
        pos = pos - torch.tensor(pad_lens, device="cuda")[:, None]
    t0 = time.perf_counter()
    rest, caches = eng.decode(first, pos, caches, steps=steps,
                              prompt_len=prompt, pad_lens=pad_lens)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    toks = torch.cat([first, rest], 1)
    prof = busy_ms(f"{path} {mode}", lambda: eng.decode(
        rest[:, -1:], pos + steps, caches, steps=PROFILED,
        prompt_len=prompt + steps, pad_lens=pad_lens))
    log(f"[main:{path}] {mode}: prefill {Bn}x{prompt}"
        f"{f' (chunks of {chunk})' if chunk else ' (one-shot)'}"
        f"{f', left pads {pad_lens}' if pad_lens else ''}: {t_pre:.3f} s "
        f"| decode {steps} steps: {t_dec:.3f} s | "
        f"{eng.cfg.num_layers} layers | card {smi}")
    record_decode(path, mode, Bn, steps, t_dec, prof, PROFILED, smi)
    return toks, caches, pos + steps + PROFILED


def run_path(path: str, eng, tokens, new: int, smi: str,
             chunk=None, pad_lens=None) -> dict:
    """generate() with the launch counts zeroed just before and read just
    after (decode replayed as CUDA graphs); then the same path split into
    prefill and decode, timed, whose tokens must equal generate()'s: two
    greedy runs of the same kernels on the same weights, prompt and
    card; then Engine(debug=True) on the same weights over the first
    DEBUG_NEW tokens (the same decode step run eagerly as a checked
    call), its launches counted as path "-debug", whose tokens must
    equal too.  chunk: the prefill chunk (None = one-shot); pad_lens:
    the rows' left pads.  Returns ({path: launches, path-debug:
    launches}, the generated tokens, the debug engine)."""
    from kivi_tpu_torch.kernels import _build
    from kivi_tpu_torch.serving.engine import Engine
    Bn, prompt = tokens.shape
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(tokens, new, prefill_chunk_size=chunk,
                       pad_lens=pad_lens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {path: dict(_build.LAUNCHES)}
    log(f"[main:{path}] generate({Bn}x{prompt}, {new} new): {wall:.2f} s, "
        f"{len(eng.graphs)} decode graph(s), launches {launches[path]}")
    check_launches(path, launches[path])
    if out.shape != (Bn, new) or out.min() < 0 or \
            out.max() >= eng.cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {tuple(out.shape)}")

    split, caches, pos = _timed_decode(path, "graphs", eng, tokens, new - 1,
                                       smi, chunk, pad_lens)
    last, _ = eng.decode_step(split[:, -1:], pos, caches,
                              pad_lens=pad_lens, flush=True)
    if not torch.isfinite(last).all():
        raise AssertionError("non-finite decode logits")
    if not torch.equal(split, out):
        bad = (split != out).any(dim=0).nonzero()
        raise AssertionError(
            f"{path}: split prefill + decode tokens differ from generate() "
            f"from step {int(bad[0])} on")
    caches = None

    dbg = Engine(cfg=eng.cfg, qcfg=eng.qcfg, params=eng.params,
                 max_seq_len=eng.max_seq_len, batch_size=eng.batch_size,
                 debug=True)
    _build.LAUNCHES.clear()
    toks, _, _ = _timed_decode(path, "debug=True", dbg, tokens,
                               DEBUG_NEW - 1, smi, chunk, pad_lens)
    launches[f"{path}-debug"] = dict(_build.LAUNCHES)
    check_launches(f"{path}-debug", launches[f"{path}-debug"])
    differ = (toks != out[:, :DEBUG_NEW]).any(dim=0).nonzero()
    if len(differ):
        raise AssertionError(f"{path}: debug=True tokens differ from the "
                             f"graphs' from step {int(differ[0])} on")
    log(f"[main:{path}] debug=True: the {DEBUG_NEW} tokens equal the "
        f"graphs'; launches {launches[f'{path}-debug']}")
    return launches, out, dbg


def run_split_steps(path: str, eng, tokens, out, chunk: int, pad_lens,
                    smi: str) -> dict:
    """The split decode route (rows 7-8), which serves host-int callers:
    a prefill into eng's own caches, then SPLIT_STEPS Engine.decode_step
    calls (flushing as they go) fed the graph run's tokens `out`, with
    the launch counts zeroed just after the prefill and read at the end
    (path "-split").  The two routes compute one function within
    ATT_RTOL (phase 3, at this geometry) but sum in another order, so a
    greedy token may differ where the top logits nearly tie: at every
    step the graph run's next token must have a split-route logit within
    phase 5's card-vs-host tolerance (5e-2 * max|logit|) of the top one;
    the steps where it is the top one and the widest such gap are
    logged.  Returns {path-split: launches}."""
    from kivi_tpu_torch.kernels import _build
    Bn, prompt = tokens.shape
    logits, caches = eng.prefill_chunked(tokens, chunk, eng.own_caches(),
                                         pad_lens)
    pos = torch.full((Bn, 1), prompt, device="cuda")
    pos = pos - torch.tensor(pad_lens, device="cuda")[:, None]
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    gaps = []
    for i in range(SPLIT_STEPS):
        logits, caches = eng.decode_step(out[:, i:i + 1], pos + i, caches,
                                         pad_lens=pad_lens, flush=True)
        want = out[:, i + 1:i + 2].long()
        top = logits.max(-1).values
        gaps.append(((top - logits.gather(-1, want)[:, 0])
                     / logits.abs().max(-1).values).max())
    gaps = torch.stack(gaps).cpu()
    wall = time.perf_counter() - t0
    key = f"{path}-split"
    launches = {key: dict(_build.LAUNCHES)}
    check_launches(key, launches[key])
    tops = int((gaps == 0).sum())
    log(f"[main:{key}] {SPLIT_STEPS} host-int decode steps fed the graph "
        f"run's tokens in {wall:.2f} s: the graphs' token is the split "
        f"route's top one at {tops} steps; widest gap to the top logit "
        f"{float(gaps.max()):.3e} x max|logit| (step "
        f"{int(gaps.argmax())}), tolerance 5e-2; launches {launches[key]}"
        f" | card {smi}")
    if not float(gaps.max()) <= 5e-2:
        raise AssertionError(f"{key}: the graph run's token lies past the "
                             "tolerance below the split route's top logit")
    return launches


def batcher_requests(n: int, vocab: int, seed: int):
    """n requests from a seeded generator: prompts of 100-1000 tokens,
    16-128 new tokens, even uids greedy, odd ones at temperature 0.8 with
    top_p 0.9 (no EOS, so each returns exactly its max_new_tokens)."""
    import numpy as np

    from kivi_tpu_torch.serving.batcher import Request
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, vocab, size=rng.randint(100, 1001)).tolist()
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_p=0.9)
        reqs.append(Request(uid=i, prompt=prompt,
                            max_new_tokens=int(rng.randint(16, 129)), **kw))
    return reqs


EAGER_STEPS = 40   # steps of the batcher's eager reference run
WINDOW = 16        # timed batcher steps per mode


def run_batcher(path: str, make, reqs, smi: str) -> dict:
    """Drive a batcher from make() over reqs with the launch counts zeroed
    just before and read just after (each step a replay of the graph for
    its fill bound); every request must come back with its
    max_new_tokens valid token ids.  Then a second batcher runs the same
    requests from the same start for EAGER_STEPS steps with the body
    run eagerly: every request's tokens so far must equal the graph
    run's, sampled rows included.  Then decode in both modes is timed on
    the first batcher (`batcher_modes`)."""
    from kivi_tpu_torch.kernels import _build
    bat = make()
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        bat.submit(r)
    steps = 0
    while bat.queue or bat.active.any():
        bat.step()
        steps += 1
    bat._retire()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check_launches(path, launches)
    V = bat.cfg.vocab_size
    for r in reqs:
        toks = bat.results[r.uid].tokens
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < V for t in toks):
            raise AssertionError(
                f"{path}: request {r.uid} returned {len(toks)} tokens, "
                f"want {r.max_new_tokens} valid ids")
    n_tok = sum(r.max_new_tokens for r in reqs)
    log(f"[main:{path}] {len(reqs)} requests, {bat.S} slots, prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)}: {n_tok} tokens in "
        f"{steps} steps, {wall:.3f} s = {n_tok / wall:.1f} generated "
        f"tokens/s, {len(bat.graphs)} decode graph(s) | "
        f"{bat.cfg.num_layers} layers | card {smi}")
    log(f"[main:{path}] launches {launches}")

    eager = make()
    eager.graphs = None
    for r in reqs:
        eager.submit(r)
    for _ in range(EAGER_STEPS):
        eager.step()
    so_far = {u: r.tokens for u, r in eager.results.items()}
    so_far.update({req.uid: eager.slot_out[s]
                   for s, req in enumerate(eager.slot_req) if req})
    for uid, toks in so_far.items():
        if toks != bat.results[uid].tokens[:len(toks)]:
            raise AssertionError(f"{path}: request {uid}'s tokens differ "
                                 "between the graphs and the eager body")
    log(f"[main:{path}] eager body, first {EAGER_STEPS} steps: "
        f"{sum(map(len, so_far.values()))} tokens of {len(so_far)} "
        f"requests ({sum(r.temperature > 0 for r in reqs)} of "
        f"{len(reqs)} sampled) equal the graphs'")
    del eager
    torch.cuda.empty_cache()
    batcher_modes(path, bat, smi)
    return launches


def batcher_modes(path: str, bat, smi: str) -> None:
    """Eight requests of 100-1000 prompt tokens admitted at once (every
    slot busy, one fill bound throughout), then WINDOW steps timed and
    PROFILED steps profiled in each mode: the graphs, then the body run
    eagerly."""
    from kivi_tpu_torch.serving.batcher import Request
    gen = torch.Generator()
    gen.manual_seed(1)
    for i, n in enumerate((100, 137, 240, 400, 555, 640, 800, 1000)):
        bat.submit(Request(uid=1000 + i, prompt=torch.randint(
            0, bat.cfg.vocab_size, (n,), generator=gen).tolist(),
            max_new_tokens=128))
    bat.step()                               # admits all eight
    graphs = bat.graphs
    for mode in ("graphs", "eager body"):
        if mode != "graphs":
            bat.graphs = None
        for _ in range(4):                   # warm (a capture, if any)
            bat.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            bat.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = busy_ms(f"{path} {mode}",
                       lambda: [bat.step() for _ in range(PROFILED)])
        record_decode(path, mode, int(bat.active.sum()), WINDOW, wall, prof,
                      PROFILED, smi)
    bat.graphs = graphs


def phase_main(layers: int, smi: str) -> dict:
    """Engine.generate on three paths, then the continuous batcher on
    three, all on one set of Llama-2-7B weights; then the long slice on
    Llama-3.1-8B weights.  Returns {path: {kernel: launches}}."""
    import dataclasses
    import functools

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine

    cfg = dataclasses.replace(PRESETS["llama2-7b"], num_layers=layers)
    t0 = time.perf_counter()
    params = modeling.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] llama2-7b width, {layers} layers: random bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    prompt, new = 1024, 128
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=gen,
                           device="cuda")
    kivi = QuantConfig(2, 2, 32, 128, v_flush=128)
    fp16 = QuantConfig(16, 16, 32, 128)
    launches = {}
    for path, qcfg in (("chunked", kivi), ("oneshot", kivi),
                       ("fp16", fp16)):
        eng = Engine(cfg=cfg, qcfg=qcfg, params=params, max_seq_len=TMAX,
                     batch_size=B)
        got, out, _ = run_path(path, eng, tokens, new, smi,
                               chunk=128 if path == "chunked" else None)
        launches.update(got)
        MAIN_TOKENS[path] = out.cpu()
        del eng
        torch.cuda.empty_cache()
        stamp(path)
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher
    for path, qcfg, chunk in (("batcher", kivi, 0),
                              ("batcher-chunked", kivi, 128),
                              ("batcher-fp16", fp16, 0)):
        make = functools.partial(
            ContinuousBatcher, cfg, qcfg, params, num_slots=B,
            max_seq_len=TMAX, prompt_buckets=(128, 256, 512, 1024),
            prefill_chunk=chunk)
        launches[path] = run_batcher(
            path, make, batcher_requests(12, cfg.vocab_size, seed=5), smi)
        torch.cuda.empty_cache()
        stamp(path)
    del params
    torch.cuda.empty_cache()
    launches.update(phase_long(layers, smi))
    return launches


def long_prompt(n: int, pad: int, vocab: int, seed: int):
    """(1, pad + n) token ids: `pad` zeros, then n seeded random ids."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    toks = torch.zeros((1, pad + n), dtype=torch.int64)
    toks[0, pad:] = torch.randint(1, vocab, (n,), generator=gen)
    return toks


def phase_long(layers: int, smi: str) -> dict:
    """The long-context slice at Llama-3.1-8B width: batch 1, a
    12,000-token prompt left-padded to 12,032, chunks of 128, a
    16,384-token cache (the LongBench runner's bucket), KIVI-2 with group
    32 and residual 32, 64 greedy tokens."""
    import dataclasses

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine

    cfg = dataclasses.replace(PRESETS["llama3.1-8b"], num_layers=layers)
    t0 = time.perf_counter()
    params = modeling.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[main:long] llama3.1-8b width, {layers} layers: random bf16 "
        f"weights in {time.perf_counter() - t0:.1f} s")
    eng = Engine(cfg=cfg, qcfg=QuantConfig(2, 2, 32, 32), params=params,
                 max_seq_len=LTMAX, batch_size=1)
    tokens = long_prompt(LFILL - LPAD, LPAD, cfg.vocab_size, seed=7)
    tokens = tokens.cuda()
    launches, out, dbg = run_path("long", eng, tokens, LNEW, smi, chunk=128,
                                  pad_lens=[LPAD])
    del eng
    torch.cuda.empty_cache()
    launches.update(run_split_steps("long", dbg, tokens, out, 128, [LPAD],
                                    smi))
    del dbg, params
    torch.cuda.empty_cache()
    return launches


def phase_probe() -> dict:
    """The ablation profiler's path at its 32K geometry (`python3 -m
    kivi_tpu_torch.profile_wide_32k --quick`: B = 4, 32 KV heads, fill
    32,640 of 32,768, KIVI-2), with the launch counts zeroed just before
    and read just after: the wide kernel and the split decode route as
    anchors, then every variant of the probe."""
    from kivi_tpu_torch import profile_wide_32k as PW
    from kivi_tpu_torch.kernels import _build
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = PW.main(["--quick"])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"[probe] profile_wide_32k --quick: {len(rows)} items in "
        f"{time.perf_counter() - t0:.1f} s, launches {launches}")
    check_launches("probe", launches)
    if not rows or not all(0 < r["ms"] < 1e3 for r in rows):
        raise AssertionError(f"probe: bad timings {rows}")
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the prefix slice at full width
# ---------------------------------------------------------------------------

PREFIX_STATS = {}   # what phase_prefix measured, for the summary lines


def _counted(path: str, fn):
    """fn() with the launch counts zeroed just before and read just after,
    checked against PATHS[path].  Returns (fn's result, launches, wall
    s)."""
    from kivi_tpu_torch.kernels import _build
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check_launches(path, launches)
    return out, launches, wall


def _equal_tokens(got, want, what: str) -> None:
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)}")
    differ = (got != want).any(dim=0).nonzero()
    if len(differ):
        raise AssertionError(f"{what}: tokens differ from step "
                             f"{int(differ[0])} on")


def _median_s(fn, n: int = 3) -> float:
    """Median host seconds of fn() to a synchronize, after one warm call."""
    import statistics
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _stream_tokens(it):
    import numpy as np
    return torch.from_numpy(np.concatenate(list(it), axis=1))


def prefix_paths(e, data: dict, tmp: str) -> dict:
    """The engine's prefix paths on engine e (batch 8, KIVI-2), each with
    its launches counted: prefill_prefix of the system prompt and
    generate(prefix=); ragged suffixes; the stream (segment 16); extend
    by 300 tokens and generate from it; the long prefix (one-shot, its
    extension at batch 1 takes the qhist route, then generate); the
    snapshot saved, loaded and generated from; beam search without and
    with the prefix.  Returns {path: (launches, tokens)}; data gains the
    snapshots made."""
    suf, beam_prompt = data["suffix"], data["beam_prompt"]
    res = {}

    def run(path, fn):
        out, launches, wall = _counted(path, fn)
        res[path] = (launches, out)
        return out

    def prefix():
        data["snap", e] = e.prefill_prefix(data["system"])
        return e.generate(suf, PNEW, prefix=data["snap", e])

    run("prefix", prefix)
    snap = data["snap", e]
    run("prefix-ragged", lambda: e.generate(suf, PNEW, prefix=snap,
                                            suffix_lens=data["lens"]))
    run("prefix-stream", lambda: _stream_tokens(
        e.generate_stream(suf, PNEW, segment=16, prefix=snap)))

    def extend():
        data["snap2", e] = e.extend(snap, data["more"])
        return e.generate(suf, PNEW, prefix=data["snap2", e])

    run("prefix-extend", extend)

    def long_prefix():
        long_snap = e.prefill_prefix(data["long"])
        c = long_snap.caches[0]
        data["long_counters"] = (c.n_k_quant, c.n_k_win, c.n_v_quant,
                                 c.n_v_win)
        e.extend(long_snap, suf[0])          # batch 1: the qhist route
        return e.generate(suf, PNEW, prefix=long_snap)

    run("prefix-qhist", long_prefix)

    def load():
        from kivi_tpu_torch.serving.engine import (load_prefix_snapshot,
                                                   save_prefix_snapshot)
        path = f"{tmp}/snap-{'debug' if e.debug else 'graphs'}"
        save_prefix_snapshot(path, snap)
        return e.generate(suf, PNEW, prefix=load_prefix_snapshot(path))

    run("prefix-load", load)
    run("beam", lambda: e.generate_beam(beam_prompt, PNEW,
                                        num_beams=BEAM_NB))
    run("beam-prefix", lambda: e.generate_beam(suf[:BEAM_B], PNEW,
                                               num_beams=BEAM_NB,
                                               prefix=snap))
    return res


def phase_prefix(layers: int, smi: str) -> dict:
    """The prefix slice at Llama-2-7B width (random bf16 weights, seed 0),
    KIVI-2 (`QuantConfig(2, 2, 32, 128, v_flush=128)`) and the fp16
    cache, a 4096-token cache, batch 8: every engine path of
    `prefix_paths` on graphs and under debug=True (tokens equal), the
    stream against generate (greedy and sampled with one seed), one beam
    against greedy, the fp16 engine behind the same prefix; then the
    timings; then the batcher (8 slots, chunks of 128, a PrefixCache of
    two system prompts) directly and over HTTP.  Returns {path:
    launches}."""
    import dataclasses
    import functools
    import tempfile

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine

    cfg = dataclasses.replace(PRESETS["llama2-7b"], num_layers=layers)
    params = modeling.init_params(cfg, seed=0, device="cuda")
    kivi = QuantConfig(2, 2, 32, 128, v_flush=128)
    fp16 = QuantConfig(16, 16, 32, 128)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(21)

    def ids(*shape):
        return torch.randint(1, cfg.vocab_size, shape, generator=gen)

    data = {"system": ids(PREFIX), "more": ids(PREFIX_MORE),
            "long": ids(PREFIX_LONG), "suffix": ids(B, SUFFIX).cuda(),
            "beam_prompt": ids(BEAM_B, BEAM_PROMPT).cuda(),
            "lens": [RAGGED_MIN + (SUFFIX - RAGGED_MIN) * i // (B - 1)
                     for i in range(B)]}
    launches = {}
    make = functools.partial(Engine, cfg=cfg, params=params,
                             max_seq_len=TMAX, batch_size=B)
    eng, dbg = make(qcfg=kivi), make(qcfg=kivi, debug=True)
    with tempfile.TemporaryDirectory() as tmp:
        got = prefix_paths(eng, data, tmp)
        ref = prefix_paths(dbg, data, tmp)
    for path, (n, toks) in got.items():
        _equal_tokens(toks, ref[path][1], f"{path}: graphs vs debug=True")
        launches[path] = n
        launches[f"{path}-debug"] = ref[path][0]
        log(f"[prefix:{path}] tokens {tuple(toks.shape)} equal debug=True's"
            f"; launches {n} | debug {ref[path][0]}")
    _equal_tokens(got["prefix-stream"][1], got["prefix"][1],
                  "stream vs generate (greedy)")
    _equal_tokens(got["prefix-load"][1], got["prefix"][1],
                  "generate from the loaded snapshot vs the snapshot")
    nkq, nkw, nvq, nvw = data["long_counters"]
    if not nvq <= nkq:
        raise AssertionError(f"long prefix {PREFIX_LONG}: n_v_quant {nvq} > "
                             f"n_k_quant {nkq}, which the qhist merge refuses")
    log(f"[prefix] long prefix {PREFIX_LONG}: counters (n_k_quant, n_k_win, "
        f"n_v_quant, n_v_win) {data['long_counters']}: n_v_quant <= "
        f"n_k_quant, as the qhist merge needs")
    snap = data["snap", eng]
    sampled = dict(temperature=0.8, top_p=0.9)
    want = eng.generate(data["suffix"], PNEW, prefix=snap,
                        generator=torch.Generator("cuda").manual_seed(11),
                        **sampled)
    _equal_tokens(_stream_tokens(eng.generate_stream(
        data["suffix"], PNEW, segment=16, prefix=snap,
        generator=torch.Generator("cuda").manual_seed(11), **sampled)),
        want, "stream vs generate (sampled, one seed)")
    beam8 = data["beam_prompt"].repeat(B // BEAM_B, 1)
    _equal_tokens(eng.generate_beam(beam8, PNEW, num_beams=1),
                  eng.generate(beam8, PNEW), "one beam vs greedy")
    log(f"[prefix] ragged suffix lengths {data['lens']}; stream == generate "
        f"(greedy and sampled with one seed); one beam == greedy generate "
        f"({B} x {BEAM_PROMPT}); the loaded snapshot's tokens == the "
        f"snapshot's")
    del dbg
    torch.cuda.empty_cache()
    fps = [make(qcfg=fp16), make(qcfg=fp16, debug=True)]
    fp_out = []
    for e in fps:
        def fp_path(e=e):
            data["fp_snap"] = e.prefill_prefix(data["system"])
            return e.generate(data["suffix"], PNEW, prefix=data["fp_snap"])
        out, n, _ = _counted("prefix-fp16", fp_path)
        fp_out.append(out)
        launches["prefix-fp16" + ("-debug" if e.debug else "")] = n
    _equal_tokens(fp_out[0], fp_out[1], "prefix-fp16: graphs vs debug=True")
    log(f"[prefix:prefix-fp16] tokens equal debug=True's; launches "
        f"{launches['prefix-fp16']} | debug {launches['prefix-fp16-debug']}")
    prefix_timings(eng, data, smi)
    del fps, data["fp_snap"]
    torch.cuda.empty_cache()
    launches.update(prefix_batcher(cfg, kivi, params, smi))
    del eng, params
    torch.cuda.empty_cache()
    return launches


def prefix_timings(eng, data: dict, smi: str) -> None:
    """prefill_prefix ms; time to first token with the prefix against the
    same full prompt one-shot and chunked; decode tokens/s and host ms a
    step on the prefix, ragged and beam paths; the stream's time to first
    token; snapshot bytes; the beam reorder's ms a step."""
    import functools

    from kivi_tpu_torch.cache import kivi_cache as KC
    from kivi_tpu_torch.serving.engine import fill_bound
    from kivi_tpu_torch.serving.prefix_cache import snapshot_bytes
    snap, suf, lens = data["snap", eng], data["suffix"], data["lens"]
    st = PREFIX_STATS
    st["prefill_prefix_ms"] = 1e3 * _median_s(
        lambda: eng.prefill_prefix(data["system"]))
    full = torch.cat([snap.tokens.expand(B, PREFIX), suf], 1)
    ingest = functools.partial(eng._ingest_prompt, max_new_tokens=PNEW)
    st["ttft_prefix_ms"] = 1e3 * _median_s(lambda: ingest(suf, prefix=snap))
    st["ttft_full_oneshot_ms"] = 1e3 * _median_s(lambda: ingest(full))
    st["ttft_full_chunked_ms"] = 1e3 * _median_s(
        lambda: ingest(full, prefill_chunk_size=128))
    log(f"[prefix:time] prefill_prefix({PREFIX}) {st['prefill_prefix_ms']:.2f}"
        f" ms; time to first token, {B} x {SUFFIX} suffix behind the "
        f"prefix {st['ttft_prefix_ms']:.2f} ms vs the full {B} x "
        f"{PREFIX + SUFFIX} prompt one-shot {st['ttft_full_oneshot_ms']:.2f}"
        f" ms, chunked (128) {st['ttft_full_chunked_ms']:.2f} ms | card {smi}")
    for path, kw in (("prefix", {}), ("prefix-ragged",
                                      {"suffix_lens": lens})):
        for _ in range(2):           # the first run captures, if need be
            pr = ingest(suf, prefix=snap, **kw)
            L = 0 if pr.ragged is None else pr.ragged[3]
            steps = L + PNEW - 1
            teach = {} if not L else {"forced": pr.ragged[1],
                                      "n_forced": pr.ragged[2]}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rest, caches = eng.decode(pr.first, pr.pos, pr.caches,
                                      steps=steps, prompt_len=pr.Tp - L,
                                      **teach)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof = busy_ms(path, lambda: eng.decode(
            rest[:, -1:], pr.pos + steps, caches, steps=PROFILED,
            prompt_len=pr.Tp - L + steps))
        record_decode(path, "graphs", B, steps, wall, prof, PROFILED, smi)
    it = eng.generate_stream(suf, PNEW, segment=16, prefix=snap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    next(it)
    st["stream_ttft_ms"] = 1e3 * (time.perf_counter() - t0)
    for _ in it:
        pass
    beam = data["beam_prompt"]
    t_long = _median_s(lambda: eng.generate_beam(beam, PNEW,
                                                 num_beams=BEAM_NB), 2)
    t_two = _median_s(lambda: eng.generate_beam(beam, 2, num_beams=BEAM_NB),
                      2)
    per = (t_long - t_two) / (PNEW - 2)
    DECODE.setdefault("beam", {})["graphs"] = dict(
        tokens_per_s=B / per, host_ms_per_step=1e3 * per, steps=PNEW - 2)
    caches = eng.own_caches()
    idx = torch.randperm(B, device="cuda")
    fb = fill_bound(BEAM_PROMPT, PNEW)
    st["reorder_ms"] = cuda_ms(lambda: [KC.reorder_into(c, idx, fb)
                                        for c in caches])
    st["reorder_full_ms"] = cuda_ms(lambda: [KC.reorder_into(c, idx)
                                             for c in caches])
    st["snapshot_bytes_kivi2"] = snapshot_bytes(snap)
    st["snapshot_bytes_fp16"] = snapshot_bytes(data["fp_snap"])
    log(f"[prefix:time] stream time to first token {st['stream_ttft_ms']:.2f}"
        f" ms; beam ({BEAM_B} x {BEAM_NB} beams, prompt {BEAM_PROMPT}): "
        f"{1e3 * per:.3f} host ms a step ({B / per:.1f} row tokens/s), "
        f"the reorder {st['reorder_ms']:.4f} ms a step below fill bound "
        f"{fb} ({st['reorder_full_ms']:.4f} ms over the whole {TMAX}); "
        f"snapshot of {PREFIX} tokens in a {TMAX}-token cache: KIVI-2 "
        f"{st['snapshot_bytes_kivi2']} bytes, fp16 "
        f"{st['snapshot_bytes_fp16']} bytes "
        f"({st['snapshot_bytes_fp16'] / st['snapshot_bytes_kivi2']:.2f}x) "
        f"| card {smi}")


def prefix_requests(n: int, vocab: int, prefixes, seed: int):
    """n requests behind the prefixes in turn: prompts of 20-300 tokens,
    16-64 new tokens, odd uids sampled (temperature 0.8, top_p 0.9)."""
    import numpy as np

    from kivi_tpu_torch.serving.batcher import Request
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_p=0.9)
        reqs.append(Request(
            uid=i, prompt=rng.randint(1, vocab, rng.randint(20, 301)).tolist(),
            max_new_tokens=int(rng.randint(16, 65)),
            prefix_tokens=prefixes[i % len(prefixes)], **kw))
    return reqs


def prefix_batcher(cfg, qcfg, params, smi: str) -> dict:
    """The batcher behind a PrefixCache (8 slots, chunks of 128): two
    system prompts, 1000 tokens and the same plus 300, so one miss, one
    extend hit, then exact hits; 12 requests.  Then the same requests over
    HTTP with "prefix" on a second batcher sharing the cache: greedy
    requests must return the same tokens."""
    import http.client
    import threading

    from kivi_tpu_torch.serving.api import ServingAPI
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher
    from kivi_tpu_torch.serving.engine import Engine
    from kivi_tpu_torch.serving.prefix_cache import PrefixCache
    gen = torch.Generator(device="cpu")
    gen.manual_seed(22)
    system = torch.randint(1, cfg.vocab_size, (PREFIX + PREFIX_MORE,),
                           generator=gen).tolist()
    pc = PrefixCache(Engine(cfg, qcfg, params, max_seq_len=TMAX,
                            batch_size=1))
    reqs = prefix_requests(12, cfg.vocab_size,
                           (system[:PREFIX], system), seed=9)

    def make():
        return ContinuousBatcher(cfg, qcfg, params, num_slots=B,
                                 max_seq_len=TMAX, prefill_chunk=128,
                                 prefix_cache=pc)

    bat = make()

    def drive():
        steps = 0
        for r in reqs:
            bat.submit(r)
        while bat.queue or bat.active.any():
            bat.step()
            steps += 1
        bat._retire()
        return steps

    steps, n, wall = _counted("batcher-prefix", drive)
    for r in reqs:
        toks = bat.results[r.uid].tokens
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"batcher-prefix: request {r.uid} returned "
                                 f"{len(toks)} tokens")
    if (pc.misses, pc.extends, pc.hits) != (1, 1, len(reqs) - 2):
        raise AssertionError(f"prefix cache: misses {pc.misses}, extends "
                             f"{pc.extends}, hits {pc.hits}")
    n_tok = sum(r.max_new_tokens for r in reqs)
    PREFIX_STATS["batcher"] = dict(
        tokens_per_s=n_tok / wall, steps=steps, hits=pc.hits,
        extends=pc.extends, misses=pc.misses, evictions=pc.evictions,
        graphs=len(bat.graphs or ()))
    log(f"[prefix:batcher-prefix] {len(reqs)} requests behind 2 system "
        f"prompts ({PREFIX}, {PREFIX + PREFIX_MORE} tokens), prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)}, {bat.S} slots, chunks of 128:"
        f" {n_tok} tokens in {steps} steps, {wall:.3f} s = "
        f"{n_tok / wall:.1f} generated tokens/s, "
        f"{PREFIX_STATS['batcher']['graphs']} graphs; "
        f"prefix cache hits {pc.hits}, extends {pc.extends}, misses "
        f"{pc.misses}, evictions {pc.evictions}, {len(pc)} stored, "
        f"{pc.nbytes} bytes | card {smi}; launches {n}")
    direct = {r.uid: bat.results[r.uid].tokens for r in reqs}
    del bat
    torch.cuda.empty_cache()
    out = {}

    def post(port, r):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/v1/generate", json.dumps({
            "prompt": r.prompt, "prefix": r.prefix_tokens,
            "max_new_tokens": r.max_new_tokens,
            "temperature": r.temperature, "top_p": r.top_p}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out[r.uid] = (resp.status, json.loads(resp.read())["tokens"])
        conn.close()

    t0 = time.perf_counter()
    with ServingAPI(make()) as srv:
        threads = [threading.Thread(target=post, args=(srv.port, r))
                   for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    for r in reqs:
        status, toks = out.get(r.uid, (None, []))
        if status != 200 or len(toks) != r.max_new_tokens:
            raise AssertionError(f"HTTP prefix request {r.uid}: {status}, "
                                 f"{len(toks)} tokens")
        if r.temperature == 0 and toks != direct[r.uid]:
            raise AssertionError(f"HTTP prefix request {r.uid}: greedy "
                                 "tokens differ from the direct run's")
    log(f"[prefix:api] {len(reqs)} concurrent requests with 'prefix' over "
        f"HTTP in {wall:.2f} s ({n_tok / wall:.1f} generated tokens/s), "
        f"greedy ones equal the direct run's; prefix cache now hits "
        f"{pc.hits}, misses {pc.misses} | card {smi}")
    return {"batcher-prefix": n}


# ---------------------------------------------------------------------------
# phase 4c: speculative serving at full width
# ---------------------------------------------------------------------------

SPEC_K, SPEC_BATCH_K = 8, 4      # speculation depth: engine, batcher
SPEC_PROMPTS = (1000, 2500)      # the second past SPLIT_MIN_HISTORY
SPEC_NEW, SPEC_SAMPLED_NEW, SPEC_DEBUG_NEW, SPEC_PROFILED = 128, 64, 24, 32
SPEC = {}                        # what phase_spec measured, for the summary
_SPEC_RUN = ("flash_attention", "quantize_pack_k", "quantize_pack_v",
             "flash_extend_attention_rows")
_SPEC_NOT = ("fused_decode_attention_wide",
             "flash_extend_attention") + SPLIT_KERNELS + PROBE
for _p, _draft_kernel, _other in (
        ("spec-self", "fp_decode_attention_kernel", "fused_decode_attention"),
        ("spec-shallow", "fused_decode_attention",
         "fp_decode_attention_kernel")):
    for _suffix in ("", "-device", "-debug"):
        PATHS[_p + _suffix] = (_SPEC_RUN + (_draft_kernel,),
                               _SPEC_NOT + (_other,))
PATHS["spec-batcher"] = (_SPEC_RUN + ("fused_decode_attention",),
                         _SPEC_NOT + ("fp_decode_attention_kernel",))


def write_hf_checkpoint(path: str, params: dict, cfg) -> None:
    """The port's parameters as an HF Llama checkpoint: config.json and
    one model.safetensors (BF16, HF names and (out, in) layout), the
    format written by hand: an 8-byte little-endian header length, the
    JSON header, the raw bytes."""
    import os
    import struct

    tensors = {"model.embed_tokens.weight": params["embed"],
               "model.norm.weight": params["ln_f"],
               "lm_head.weight": params["lm_head"].t()}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "wg": "mlp.gate_proj", "wu": "mlp.up_proj",
             "wd": "mlp.down_proj"}
    for i, lp in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        tensors[pre + "input_layernorm.weight"] = lp["ln_attn"]
        tensors[pre + "post_attention_layernorm.weight"] = lp["ln_mlp"]
        for n, hf in names.items():
            tensors[pre + hf + ".weight"] = lp[n].t()
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().to(torch.bfloat16).view(torch.int16).cpu(
        ).numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_theta,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f)


def _same_params(a: dict, b: dict, what: str) -> None:
    """Every tensor of two parameter dicts bit-equal (dtype and shape
    too)."""
    pairs = [(k, a[k], b[k]) for k in ("embed", "ln_f", "lm_head")]
    pairs += [(f"layers.{i}.{n}", la[n], lb[n])
              for i, (la, lb) in enumerate(zip(a["layers"], b["layers"]))
              for n in la]
    if len(a["layers"]) != len(b["layers"]):
        raise AssertionError(f"{what}: layer counts differ")
    for name, x, y in pairs:
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x, y.to(x.device)):
            raise AssertionError(f"{what}: {name} is not bit-equal")


def shallow_draft(cfg, smi: str):
    """The shallow draft (2 layers at the target's width, seeded random
    weights) brought onto the card the way a real checkpoint comes: its
    weights written as an HF directory (model.safetensors, BF16, and
    config.json), read back through load_hf_checkpoint, then through
    save_checkpoint / load_checkpoint, each bit-equal to the written
    tensors."""
    import dataclasses
    import tempfile

    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.models.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from kivi_tpu_torch.models.hf_loader import load_hf_checkpoint
    dcfg = dataclasses.replace(cfg, num_layers=2)
    written = modeling.init_params(dcfg, seed=11, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_hf_checkpoint(f"{tmp}/hf", written, dcfg)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        lcfg, loaded = load_hf_checkpoint(f"{tmp}/hf", device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if lcfg != dcfg:
            raise AssertionError(f"config_from_hf: {lcfg} != {dcfg}")
        _same_params(written, loaded, "load_hf_checkpoint")
        save_checkpoint(f"{tmp}/native", loaded, lcfg)
        ncfg, native = load_checkpoint(f"{tmp}/native", device="cuda")
        if ncfg != dcfg:
            raise AssertionError(f"load_checkpoint: {ncfg} != {dcfg}")
        _same_params(written, native, "save/load_checkpoint")
    del written, loaded
    log(f"[spec] shallow draft (2 layers, llama2-7b width): written as an "
        f"HF safetensors directory in {t_write:.1f} s, read back by "
        f"load_hf_checkpoint in {t_load:.1f} s, every tensor bit-equal; "
        f"save_checkpoint + load_checkpoint bit-equal | card {smi}")
    return dcfg, native


def teacher_gaps(eng, prompts, pad_lens, streams, per_row: bool = False,
                 positions: bool = False):
    """Each row's greedy stream fed through the target engine eng (batch
    = rows, host-int decode_step after a one-shot prefill, as the
    speculative paths prefill): at every position, the gap between the
    engine's top logit and the logit of the stream's token there, over
    max|logit|.  Returns (the widest gap, the share of positions where
    the stream's token is the engine's top one), or with per_row a list
    of them, one per row, or with positions each row's gaps, one a
    position of its stream."""
    Bn, T = prompts.shape
    L = max(len(s) for s in streams)
    toks = torch.tensor([s + [s[-1]] * (L - len(s)) for s in streams],
                        device="cuda")
    valid = torch.tensor([[i < len(s) for i in range(L)] for s in streams],
                         device="cuda")
    logits, caches = eng._prefill(prompts, eng.own_caches(), pad_lens)
    pos = torch.full((Bn, 1), T, device="cuda")
    if pad_lens is not None:
        pos = pos - torch.tensor(pad_lens, device="cuda")[:, None]
    gaps = []
    for i in range(L):
        top = logits.max(-1).values
        gaps.append((top - logits.gather(-1, toks[:, i:i + 1])[:, 0])
                    / logits.abs().max(-1).values)
        if i + 1 < L:
            logits, caches = eng.decode_step(toks[:, i:i + 1], pos + i,
                                             caches, pad_lens=pad_lens,
                                             flush=True)
    gaps, valid = torch.stack(gaps, 1).cpu(), valid.cpu()
    if positions:
        return [g[v] for g, v in zip(gaps, valid)]
    if per_row:
        return [(float(g[v].max()), float((g[v] == 0).float().mean()))
                for g, v in zip(gaps, valid)]
    gaps = gaps[valid]
    return float(gaps.max()), float((gaps == 0).float().mean())


def _hold_to_target(what: str, gap: float, top_share: float,
                    equal: float) -> None:
    log(f"[spec] {what}: widest gap to the target's top logit "
        f"{gap:.3e} x max|logit| (tolerance 5e-2, phase 5's), the "
        f"target's top token at {top_share:.3f} of the positions, equal "
        f"to Engine.generate's stream at {equal:.3f}")
    if not gap <= 5e-2:
        raise AssertionError(f"{what}: a greedy token lies past the "
                             "tolerance below the target's top logit")


def _share_equal(a, b) -> float:
    a, b = list(a), list(b)
    return sum(x == y for x, y in zip(a, b)) / max(len(b), 1)


def run_spec_engine(draft: str, spec, dbg, prompts: dict, ref: dict,
                    smi: str) -> tuple:
    """One draft's speculative engine paths at batch 1: generate (each
    step replayed as a CUDA graph) on every prompt, timed after a
    warm-up and profiled; the stream, equal to generate; a sampled run
    twice under one seed, equal; generate_device, equal to generate;
    the debug=True engine (every step a checked call) over the first
    SPEC_DEBUG_NEW tokens, equal.  Returns ({path: launches}, {prompt
    length: greedy stream (1, SPEC_NEW)})."""
    import numpy as np

    from kivi_tpu_torch.kernels import _build
    path = f"spec-{draft}"
    launches = {}
    outs = {}
    _build.LAUNCHES.clear()
    for n, toks in prompts.items():
        spec.generate(toks, 16)                  # warm-up: the captures
        spec.stats = dict.fromkeys(spec.stats, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = spec.generate(toks, SPEC_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc = spec.last_acceptance
        outs[n] = out
        prof = busy_ms(f"{path} {n}",
                       lambda: spec.generate(toks, SPEC_PROFILED))
        m = SPEC.setdefault(path, {})[n] = dict(
            tokens_per_s=SPEC_NEW / wall, iterations=len(acc),
            mean_accepted=float(np.mean(acc)),
            tokens_per_iteration=(SPEC_NEW - 1) / len(acc),
            clamped=spec.stats["clamped"],
            boundary_flushes=spec.stats["boundary_flush_k"]
            + spec.stats["boundary_flush_v"],
            host_ms_per_iteration=wall * 1e3 / len(acc),
            busy_ms=prof[0], profiled_wall_ms=prof[1],
            idle_share=1 - prof[0] / prof[1])
        log(f"[spec:{path}] prompt {n}, k={spec.k}, {SPEC_NEW} greedy "
            f"tokens: {m['tokens_per_s']:.1f} tokens/s (target "
            f"Engine.generate {ref[n]['tokens_per_s']:.1f}), "
            f"{len(acc)} iterations, mean accepted {m['mean_accepted']:.2f}"
            f" ({m['tokens_per_iteration']:.2f} tokens an iteration), "
            f"clamped {m['clamped']}, boundary flushes "
            f"{m['boundary_flushes']}, host {m['host_ms_per_iteration']:.2f}"
            f" ms an iteration | {SPEC_PROFILED} tokens profiled: busy "
            f"{prof[0]:.1f} of {prof[1]:.1f} ms, idle share "
            f"{m['idle_share']:.4f} | card {smi}")
    launches[path] = dict(_build.LAUNCHES)
    check_launches(path, launches[path])
    log(f"[spec:{path}] launches {launches[path]}")

    first = next(iter(prompts))
    toks = prompts[first]
    stream = np.concatenate(list(spec.generate_stream(toks, SPEC_NEW)))
    _equal_tokens(stream[None], outs[first], f"{path} stream vs generate")
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    sampled = []
    for _ in range(2):
        g = torch.Generator(device="cuda")
        g.manual_seed(21)
        sampled.append(spec.generate(toks, SPEC_SAMPLED_NEW, generator=g,
                                     **kw))
    _equal_tokens(sampled[0], sampled[1], f"{path} sampled, one seed")
    if sampled[0].shape != (1, SPEC_SAMPLED_NEW) or sampled[0].max() >= \
            spec.target.cfg.vocab_size:
        raise AssertionError(f"{path}: bad sampled tokens")
    _build.LAUNCHES.clear()
    for n, t in prompts.items():
        dev = spec.generate_device(t, SPEC_NEW)
        _equal_tokens(dev, outs[n], f"{path} generate_device vs generate, "
                                    f"prompt {n}")
    launches[path + "-device"] = dict(_build.LAUNCHES)
    check_launches(path + "-device", launches[path + "-device"])
    _build.LAUNCHES.clear()
    for n, t in prompts.items():
        got = dbg.generate(t, SPEC_DEBUG_NEW)
        _equal_tokens(got, outs[n][:, :SPEC_DEBUG_NEW],
                      f"{path} debug=True vs graphs, prompt {n}")
    launches[path + "-debug"] = dict(_build.LAUNCHES)
    check_launches(path + "-debug", launches[path + "-debug"])
    log(f"[spec:{path}] stream equal to generate; sampled (temperature "
        f"0.8, top-k 50, top-p 0.95) equal twice under one seed; "
        f"generate_device equal to generate on every prompt; debug=True "
        f"equal over {SPEC_DEBUG_NEW} tokens; launches device "
        f"{launches[path + '-device']}, debug {launches[path + '-debug']}")
    return launches, outs


def run_spec_batcher(cfg, qcfg, params, dcfg, dparams, smi: str) -> dict:
    """SpeculativeBatcher (shallow draft, 8 slots, k = 4) over the 12
    requests of batcher_requests, each step two graph replays, its
    launches counted; the same requests from the same start with the
    bodies run eagerly for EAGER_STEPS steps must give the graphs'
    tokens; every greedy request's stream teacher-forced through a
    target Engine at its bucket's left pad."""
    from kivi_tpu_torch.kernels import _build
    from kivi_tpu_torch.serving.engine import Engine
    from kivi_tpu_torch.serving.spec_batcher import SpeculativeBatcher
    buckets = (128, 256, 512, 1024)
    reqs = batcher_requests(12, cfg.vocab_size, seed=5)

    def make():
        return SpeculativeBatcher(cfg, qcfg, params, dcfg, qcfg, dparams,
                                  num_slots=B, max_seq_len=TMAX,
                                  k=SPEC_BATCH_K, prompt_buckets=buckets)

    bat = make()
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        bat.submit(r)
    steps = 0
    while bat.queue or bat.active.any():
        bat.step()
        steps += 1
    bat._retire()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"spec-batcher": dict(_build.LAUNCHES)}
    check_launches("spec-batcher", launches["spec-batcher"])
    V = cfg.vocab_size
    for r in reqs:
        toks = bat.results[r.uid].tokens
        if len(toks) != r.max_new_tokens or not all(0 <= t < V
                                                    for t in toks):
            raise AssertionError(f"spec-batcher: request {r.uid} returned "
                                 f"{len(toks)} tokens")
    st = bat.stats
    n_tok = sum(r.max_new_tokens for r in reqs)
    SPEC["spec-batcher"] = dict(
        generated_tokens_per_s=n_tok / wall, steps=steps,
        mean_accepted=st["accepted"] / st["slot_steps"],
        clamped=st["clamped"], host_ms_per_step=wall * 1e3 / steps)
    log(f"[spec:spec-batcher] {len(reqs)} requests, {bat.S} slots, k="
        f"{bat.k}, shallow draft: {n_tok} tokens in {steps} steps, "
        f"{wall:.3f} s = {n_tok / wall:.1f} generated tokens/s, mean "
        f"accepted {SPEC['spec-batcher']['mean_accepted']:.3f} a slot "
        f"step, clamped {st['clamped']}, {len(bat.graphs)} graph(s) | "
        f"{cfg.num_layers} layers | card {smi}")
    log(f"[spec:spec-batcher] launches {launches['spec-batcher']}")

    eager = make()
    eager.graphs = None
    for r in reqs:
        eager.submit(r)
    for _ in range(EAGER_STEPS):
        eager.step()
    so_far = {u: r.tokens for u, r in eager.results.items()}
    so_far.update({req.uid: eager.slot_out[s]
                   for s, req in enumerate(eager.slot_req) if req})
    for uid, toks in so_far.items():
        if toks != bat.results[uid].tokens[:len(toks)]:
            raise AssertionError(f"spec-batcher: request {uid}'s tokens "
                                 "differ between the graphs and the eager "
                                 "bodies")
    log(f"[spec:spec-batcher] eager bodies, first {EAGER_STEPS} steps: "
        f"{sum(map(len, so_far.values()))} tokens of {len(so_far)} "
        "requests equal the graphs'")
    results = {u: r.tokens for u, r in bat.results.items()}
    del eager, bat
    torch.cuda.empty_cache()
    # the greedy streams against the target, one Engine per bucket
    greedy = [r for r in reqs if r.temperature == 0.0]
    worst, tops, equal = 0.0, [], []
    for bucket in buckets:
        group = [r for r in greedy
                 if next(b for b in buckets if len(r.prompt) <= b) == bucket]
        if not group:
            continue
        pads = [bucket - len(r.prompt) for r in group]
        prompts = torch.tensor([[0] * p + r.prompt
                                for p, r in zip(pads, group)], device="cuda")
        eng = Engine(cfg=cfg, qcfg=qcfg, params=params, max_seq_len=TMAX,
                     batch_size=len(group))
        streams = [results[r.uid] for r in group]
        gap, top = teacher_gaps(eng, prompts, pads, streams)
        want = eng.generate(prompts, max(r.max_new_tokens for r in group),
                            pad_lens=pads).tolist()
        worst = max(worst, gap)
        tops.append(top)
        equal += [_share_equal(s, w[:len(s)]) for s, w in zip(streams,
                                                               want)]
        del eng
    SPEC["spec-batcher"].update(gap=worst, equal_share=equal)
    _hold_to_target(f"spec-batcher ({len(greedy)} greedy requests)", worst,
                    min(tops), min(equal))
    log(f"[spec:spec-batcher] per-request share equal to Engine.generate: "
        f"{[round(e, 3) for e in equal]}")
    return launches


def phase_spec(layers: int, smi: str) -> dict:
    """The speculative paths at Llama-2-7B width, `layers` deep: the
    target (KIVI-2, the main path's QuantConfig) at batch 1 timed alone
    on prompts of SPEC_PROMPTS tokens, then SpeculativeEngine (k = 8)
    with draft "self" (the target's weights over an fp16 cache) and draft
    "shallow" (2 layers over KIVI-2, loaded from an HF directory), then
    SpeculativeBatcher with the shallow draft.  Returns {path:
    launches}."""
    import dataclasses

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine
    from kivi_tpu_torch.serving.speculative import SpeculativeEngine

    cfg = dataclasses.replace(PRESETS["llama2-7b"], num_layers=layers)
    params = modeling.init_params(cfg, seed=0, device="cuda")
    kivi = QuantConfig(2, 2, 32, 128, v_flush=128)
    fp16 = QuantConfig(16, 16, 32, 128)
    dcfg, dparams = shallow_draft(cfg, smi)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(13)
    prompts = {n: torch.randint(1, cfg.vocab_size, (1, n),
                                generator=gen).cuda() for n in SPEC_PROMPTS}
    target = Engine(cfg=cfg, qcfg=kivi, params=params, max_seq_len=TMAX,
                    batch_size=1)
    ref = {}
    for n, toks in prompts.items():
        target.generate(toks, 16)                  # warm-up: the captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = target.generate(toks, SPEC_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = busy_ms(f"target {n}",
                       lambda: target.generate(toks, SPEC_PROFILED))
        ref[n] = dict(tokens=out[0].tolist(), tokens_per_s=SPEC_NEW / wall,
                      busy_ms=prof[0], profiled_wall_ms=prof[1],
                      idle_share=1 - prof[0] / prof[1])
        log(f"[spec:target] Engine.generate at batch 1, prompt {n}, "
            f"{SPEC_NEW} greedy tokens (one-shot prefill included): "
            f"{ref[n]['tokens_per_s']:.1f} tokens/s | {SPEC_PROFILED} "
            f"tokens profiled: busy {prof[0]:.1f} of {prof[1]:.1f} ms, "
            f"idle share {ref[n]['idle_share']:.4f} | {layers} layers | "
            f"card {smi}")
    SPEC["target"] = {n: {k: v for k, v in r.items() if k != "tokens"}
                      for n, r in ref.items()}
    dbg_target = Engine(cfg=cfg, qcfg=kivi, params=params, max_seq_len=TMAX,
                        batch_size=1, debug=True)
    launches, streams = {}, {}
    drafts = (("self", (cfg, fp16, params)), ("shallow", (dcfg, kivi,
                                                          dparams)))
    for name, (dc, dq, dp) in drafts:
        draft = Engine(cfg=dc, qcfg=dq, params=dp, max_seq_len=TMAX,
                       batch_size=1)
        dbg_draft = Engine(cfg=dc, qcfg=dq, params=dp, max_seq_len=TMAX,
                           batch_size=1, debug=True)
        got, streams[name] = run_spec_engine(
            name, SpeculativeEngine(target, draft, k=SPEC_K),
            SpeculativeEngine(dbg_target, dbg_draft, k=SPEC_K), prompts,
            ref, smi)
        launches.update(got)
        del draft, dbg_draft
        torch.cuda.empty_cache()
        stamp(f"spec-{name}")
    del target, dbg_target
    torch.cuda.empty_cache()
    # both drafts' greedy streams of a prompt teacher-forced through the
    # target at once (batch 2, the prompt in both rows)
    tf = Engine(cfg=cfg, qcfg=kivi, params=params, max_seq_len=TMAX,
                batch_size=len(drafts))
    for n, toks in prompts.items():
        rows = [streams[name][n][0].tolist() for name, _ in drafts]
        gaps = teacher_gaps(tf, toks.expand(len(drafts), -1), None, rows,
                            per_row=True)
        for (name, _), row, (gap, top) in zip(drafts, rows, gaps):
            equal = _share_equal(row, ref[n]["tokens"])
            _hold_to_target(f"spec-{name} prompt {n}", gap, top, equal)
            SPEC[f"spec-{name}"][n].update(gap=gap, top_share=top,
                                           equal_share=equal)
    del tf
    torch.cuda.empty_cache()
    launches.update(run_spec_batcher(cfg, kivi, params, dcfg, dparams, smi))
    del params, dparams
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4d: the parallel tier (one card: the (1, 1) mesh over NCCL)
# ---------------------------------------------------------------------------

PARALLEL = {}      # what phase_parallel measured, for the summary line
MAIN_TOKENS = {}   # phase_main's generate() tokens by path (held by (c))
PAR_NEW = 64       # tokens teacher-forced off the sequence-parallel caches
ELASTIC_FAIL = 20  # batcher steps before the elastic batcher's recovery
WATCHDOG_S = 120.0   # StepWatchdog deadline a batcher step must meet
# the kernels outside a one-shot KIVI serving path (prefill row 10 or the
# ring, ingest rows 1-2, decode row 6)
_PAR_NOT = ("flash_extend_attention", "flash_extend_attention_rows",
            "flash_extend_qhist", "fused_decode_attention_wide",
            "qk_dequant_matmul", "pv_dequant_matmul",
            "fp_decode_attention_kernel") + PROBE
PATHS.update({
    # Engine.generate at the long slice's geometry, one-shot prefill
    "parallel-oneshot": (("flash_attention", "quantize_pack_k",
                          "quantize_pack_v", "fused_decode_attention"),
                         _PAR_NOT),
    # prefill_seqpar (the ring, plain f32 torch, instead of row 10), then
    # the teacher-forced decode steps
    "parallel-seqpar": (("quantize_pack_k", "quantize_pack_v",
                         "fused_decode_attention"),
                        _PAR_NOT + ("flash_attention",)),
    "parallel-striped": (("quantize_pack_k", "quantize_pack_v",
                          "fused_decode_attention"),
                         _PAR_NOT + ("flash_attention",)),
    "parallel-tp": PATHS["oneshot"],
    "parallel-elastic-fp16": PATHS["batcher-fp16"],
    "parallel-elastic": PATHS["batcher"],
})


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_group(smi: str):
    """(a) multihost.initialize at world 1 over NCCL (a TCP store on a
    free local port), global_mesh (1, 1) on cuda, and one NCCL
    all_reduce and one all_gather over each of the mesh's groups.
    Returns the mesh."""
    import torch.distributed as dist

    from kivi_tpu_torch.parallel import multihost
    dev = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    mesh = multihost.global_mesh(num_kv_heads=8)
    if (tuple(mesh.mesh.shape) != (1, 1) or mesh.device_type != "cuda"
            or dist.get_backend() != "nccl" or dev.type != "cuda"):
        raise AssertionError(f"parallel: mesh {tuple(mesh.mesh.shape)} on "
                             f"{mesh.device_type}, backend "
                             f"{dist.get_backend()}")
    for axis in ("data", "model"):
        g = mesh.get_group(axis)
        x = torch.arange(1, 5, dtype=torch.float32, device="cuda")
        dist.all_reduce(x, group=g)
        out = torch.empty(4 * g.size(), dtype=torch.float32, device="cuda")
        dist.all_gather_into_tensor(out, x, group=g)
        want = torch.arange(1, 5, dtype=torch.float32, device="cuda")
        if not (torch.equal(x, want) and torch.equal(out, want)):
            raise AssertionError(f"parallel: NCCL collectives over "
                                 f"'{axis}' gave {x.tolist()}, "
                                 f"{out.tolist()}")
    log(f"[parallel:group] initialize at world 1: backend "
        f"{dist.get_backend()}, mesh {tuple(mesh.mesh.shape)} "
        f"('data', 'model') on {dev}; an all_reduce and an all_gather over "
        f"each axis' group as expected | card {smi}")
    return mesh


def _live_codes_equal(a, b, bits: int) -> tuple:
    """(the share of equal packed words, the share of equal `bits`-bit
    codes) of two caches' K and V stores over the filled positions, the
    lower of K's and V's each."""
    words, codes = [], []
    shift = torch.arange(0, 32, bits, device="cuda")
    for f, n in (("k_codes", a.n_k_quant), ("v_codes", a.n_v_quant)):
        x, y = getattr(a, f)[..., :n], getattr(b, f)[..., :n]
        words.append((x == y).float().mean().item())
        cx = (x[..., None] >> shift) & ((1 << bits) - 1)
        cy = (y[..., None] >> shift) & ((1 << bits) - 1)
        codes.append((cx == cy).float().mean().item())
    return min(words), min(codes)


def check_ring(smi: str) -> None:
    """The ring of one on the card against the f32 plain causal attention
    (flash_attention_plain) at the long slice's heads (32 query, 8 KV,
    D 128), 2,048 tokens with 32 left pads, score chunks of 256: both
    f32 from the same bf16 inputs, so within 2e-5 of max|out| on the
    real rows (a pad row's output is garbage by convention in the
    ring)."""
    from kivi_tpu_torch.kernels.flash import flash_attention_plain
    from kivi_tpu_torch.parallel.ring import ring_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    T, pad = 2048, torch.tensor([32], device="cuda")
    q = _randn(gen, (1, 32, T, D))
    k, v = _randn(gen, (1, 8, T, D)), _randn(gen, (1, 8, T, D))
    got = ring_attention(q.float(), k, v, None, pad_len=pad,
                         score_chunk=256)[:, :, 32:]
    want = flash_attention_plain(q, k, v, pad_len=pad)[:, :, 32:]
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[parallel:ring] ring_attention (a ring of one, chunks of 256) vs "
        f"flash_attention_plain on the card, 1 x 32/8 heads x {T} tokens "
        f"(32 left pads): max|diff| {err:.3e} (max|out| {scale:.3e}, "
        f"tolerance {2e-5 * scale:.3e}) | card {smi}")
    if not err <= 2e-5 * scale:
        raise AssertionError("parallel: the ring disagrees with the f32 "
                             "plain attention")


def _teacher_forced(eng, caches, logits, ref, T: int, pad: int) -> tuple:
    """The one-shot run's stream ref (1, n) teacher-forced off caches
    holding a T-token prompt: the gap between the top logit and ref's
    token at each of its n positions, over max|logit| (the first from
    the prefill's logits, then n - 1 replayed decode steps over the
    caches' counters on the device, row 6, each a one-step
    Engine.decode).  Returns (the widest gap, the share where ref's
    token is the top one)."""
    n = ref.shape[1]
    gaps = []
    for i in range(n):
        top = logits.max(-1).values
        gaps.append(((top - logits.gather(-1, ref[:, i:i + 1].long())[:, 0])
                     / logits.abs().max(-1).values).max())
        if i + 1 < n:
            pos = torch.full((1, 1), T - pad + i, device="cuda")
            eng.decode(ref[:, i:i + 1], pos, caches, steps=1,
                       prompt_len=T + i, pad_lens=[pad])
            logits = eng._dec.logits
    gaps = torch.stack(gaps).cpu()
    return float(gaps.max()), float((gaps == 0).float().mean())


def parallel_seqpar(mesh, layers: int, smi: str) -> dict:
    """(b) Engine.prefill_seqpar at the long slice's geometry (Llama-3.1-8B
    width, KIVI-2 group 32 residual 32, 12,000 tokens left-padded to
    12,032, a 16,384-token cache), contiguous and striped, against the
    one-shot Engine.prefill (row 10) on the same weights: the last logits
    within phase 5's tolerance (5e-2 of max|logit|); layer 0's packed K/V
    words >= 99.9% equal over the filled positions (its K/V come from the
    same inputs: the ring's gather, order and pad zeroing are exact);
    every deeper layer's 2-bit codes >= 95% equal (the one-shot
    reference's attention runs bf16 operands on the tensor cores, the
    ring f32, and that rounding, compounding with depth, flips codes near
    their boundaries: 0.9975 at layer 1 down to 0.981 at layer 31 on
    this geometry, where a misplaced token would leave ~1/4 equal); then
    the one-shot run's PAR_NEW greedy tokens teacher-forced off each
    seqpar's caches, each within phase_spec's 5e-2 of the top logit.  At
    n = 1 the ring is one block of plain f32 torch and zigzag_perm is the
    identity."""
    import dataclasses

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.kernels import _build
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine

    cfg = dataclasses.replace(PRESETS["llama3.1-8b"], num_layers=layers)
    params = modeling.init_params(cfg, seed=0, device="cuda")
    eng = Engine(cfg=cfg, qcfg=QuantConfig(2, 2, 32, 32), params=params,
                 max_seq_len=LTMAX, batch_size=1)
    tokens = long_prompt(LFILL - LPAD, LPAD, cfg.vocab_size, seed=7).cuda()
    launches = {}
    _build.LAUNCHES.clear()
    ref = eng.generate(tokens, PAR_NEW, pad_lens=[LPAD])
    torch.cuda.synchronize()
    launches["parallel-oneshot"] = dict(_build.LAUNCHES)
    check_launches("parallel-oneshot", launches["parallel-oneshot"])
    times = {}

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[what] = (time.perf_counter() - t0) * 1e3
        return out

    lg1, c1 = timed("oneshot", lambda: eng._prefill(
        tokens, eng.init_caches(), [LPAD]))
    scale = lg1.abs().max().item()
    for path, striped in (("parallel-seqpar", False),
                          ("parallel-striped", True)):
        _build.LAUNCHES.clear()
        lg2, c2 = timed(path, lambda: eng.prefill_seqpar(
            tokens, mesh, "data", caches=eng.init_caches(),
            pad_lens=[LPAD], striped=striped))
        err = (lg2 - lg1).abs().max().item()
        shares = [_live_codes_equal(a, b, 2) for a, b in zip(c1, c2)]
        words0, codes = shares[0][0], min(c for _, c in shares[1:])
        gap, top = _teacher_forced(eng, c2, lg2, ref, LFILL, LPAD)
        torch.cuda.synchronize()
        launches[path] = dict(_build.LAUNCHES)
        check_launches(path, launches[path])
        log(f"[{path}] prefill_seqpar over the (1, 1) mesh's 'data' axis "
            f"(a ring of one), 1 x {LFILL} ({LPAD} left pads), "
            f"{layers} layers, striped={striped}: {times[path]:.1f} ms, "
            f"the ring's plain f32 torch, slower than the one-shot "
            f"Engine.prefill on row 10's tensor cores "
            f"({times['oneshot']:.1f} ms) as expected; "
            f"logits max|seqpar - one-shot| = {err:.3e} (max|one-shot| "
            f"{scale:.3e}, tolerance {5e-2 * scale:.3e}); over the filled "
            f"positions layer 0's packed K/V words {words0:.5f} equal "
            f"(>= 0.999), the 2-bit codes of layers 1-{layers - 1} "
            f"{shares[1][1]:.5f} ... {shares[-1][1]:.5f} equal, min "
            f"{codes:.5f} (>= 0.95); the one-shot run's {PAR_NEW} greedy "
            f"tokens "
            f"teacher-forced off the seqpar caches: widest gap to the top "
            f"logit {gap:.3e} x max|logit| (5e-2), the top one at "
            f"{top:.3f} of positions; launches {launches[path]} | "
            f"card {smi}")
        if not err <= 5e-2 * scale:
            raise AssertionError(f"{path}: logits disagree with one-shot")
        if not (words0 >= 0.999 and codes >= 0.95):
            raise AssertionError(f"{path}: K/V codes {words0:.5f} / "
                                 f"{codes:.5f} equal")
        if not gap <= 5e-2:
            raise AssertionError(f"{path}: a one-shot token lies past the "
                                 "tolerance below the top logit")
        PARALLEL[path] = dict(ms=times[path], logit_err=err,
                              words_equal_layer0=words0,
                              codes_equal_min=codes, gap=gap, top_share=top)
        del c2
    PARALLEL["oneshot_prefill_ms"] = times["oneshot"]
    del eng, params, c1
    torch.cuda.empty_cache()
    return launches


def _resumed_streams(path, cfg, qcfg, params, reqs, got, want, before,
                     flight, buckets) -> str:
    """Hold the elastic run's own output after the recovery through a
    batch-1 Engine over the run's cache config (`qcfg`, the fp16 or the
    KIVI-2 one): every stream with tokens made after recover() (the
    resumed ones from prompt + pre-failure tokens, the ones admitted
    later from their prompt) is teacher-forced from that prompt
    left-padded to the smallest of `buckets` that holds it (the
    batcher's layout, pads computed here: as phase 6 and
    tests/test_batcher.py::_oracle hold the batcher, since KIVI-2's
    quantization groups follow the pads), and each of its tokens must
    lie within 5e-2 of max|logit| below the top (as phase_spec holds its
    streams).  A fault in the resumed admission (the replayed
    bucketed prompt's positions or pads, the rebuilt slot caches, the
    graphs captured again) would put tokens far below the top.

    With the uninterrupted batcher's streams `want` (fp16): every
    pre-failure stream is a prefix of the uninterrupted one, and the
    requests not in flight at the failure equal it token for token.  A
    resumed request replays its prompt through row 10's prefill (bf16
    operands on the tensor cores), which rounds otherwise than the row 9
    decode steps that made those tokens (f32), so its stream may fork at
    a near tie: its uninterrupted continuation is teacher-forced too
    (the same bound), and at the first position where the two streams
    differ the Engine's logits of the two tokens must lie within 5e-2 of
    max|logit| of each other (a near tie).  Returns the log's account."""
    from kivi_tpu_torch.serving.engine import Engine
    if want is not None:
        for u, pre in before.items():
            if want[u][:len(pre)] != pre:
                raise AssertionError(f"{path}: uid {u}'s pre-failure "
                                     "stream is not the uninterrupted one's")
        bad = [u for u in want if u not in flight and got[u] != want[u]]
        if bad:
            raise AssertionError(f"{path}: uids {bad}, not in flight at "
                                 "the failure, differ from the "
                                 "uninterrupted run")
    rows = 1 if want is None else 2
    eng = Engine(cfg=cfg, qcfg=qcfg, params=params, max_seq_len=TMAX,
                 batch_size=rows)
    orig = {r.uid: r for r in reqs}
    after = sorted(u for u in got if u in flight or u not in before)
    gaps, want_gaps, ties, worst, equal, total = [], [], {}, {}, 0, 0
    for u in after:
        pre = before.get(u, [])
        streams = [got[u][len(pre):]]
        if want is not None and u in flight:
            streams.append(want[u][len(pre):])
        n = len(orig[u].prompt) + len(pre)
        pad = next(b for b in buckets if n <= b) - n
        prompt = torch.tensor([[0] * pad + list(orig[u].prompt) + pre]
                              * rows, device="cuda")
        held = teacher_gaps(eng, prompt, [pad] * rows,
                            streams + streams[:1] * (rows - len(streams)),
                            positions=True)
        gaps.append(float(held[0].max()))
        worst[u] = (len(pre) + int(held[0].argmax()), gaps[-1])
        if len(streams) == 2:
            want_gaps.append(float(held[1].max()))
            same = [a == b for a, b in zip(*streams)]
            equal += sum(same)
            total += len(same)
            if not all(same):
                i = same.index(False)
                # the two rows share their input up to the fork, so the
                # gaps there are to one top logit
                ties[u] = (len(pre) + i,
                           abs(float(held[0][i] - held[1][i])))
    del eng
    torch.cuda.empty_cache()
    widest = max(gaps + want_gaps)
    tie = max((t for _, t in ties.values()), default=0.0)
    PARALLEL[path + "-held"] = dict(
        streams_held=len(after), widest_gap=max(gaps),
        uninterrupted_widest_gap=max(want_gaps, default=None),
        resumed_equal_share=equal / total if total else None,
        forks={u: i for u, (i, _) in ties.items()}, widest_fork_tie=tie,
        widest_gap_by_uid=worst)
    log(f"[{path}] after the recovery, each stream's widest gap to the "
        f"Engine's top logit (uid: stream position, gap / max|logit|): "
        f"{worst}")
    if not widest <= 5e-2:
        raise AssertionError(f"{path}: a token after the recovery lies past "
                             "the tolerance below the Engine's top logit")
    if not tie <= 5e-2:
        raise AssertionError(f"{path}: a resumed stream forks from the "
                             "uninterrupted one where the Engine shows no "
                             "near tie")
    account = (f"the {len(after)} streams made after the recovery "
               f"teacher-forced through a batch-1 Engine over the same "
               f"cache: widest gap to the top logit {max(gaps):.3e} x "
               f"max|logit| (5e-2)")
    if want is None:
        return account + "; every pre-failure stream a prefix of its final one"
    return (account + f"; streams not in flight equal the uninterrupted "
            f"batcher's; the {len(flight)} resumed: pre-failure prefixes "
            f"equal, {equal}/{total} later tokens equal to the "
            f"uninterrupted run's, whose continuations lie within "
            f"{max(want_gaps):.3e} of the top; forks (stream position, "
            f"|logit gap| between the two tokens / max|logit|) {ties}, "
            f"each a near tie (5e-2)")


def _parallel_llama2(layers: int):
    """The main path's Llama-2-7B config at `layers` and its weights
    (seed 0), for (c) and (d)."""
    import dataclasses

    from kivi_tpu_torch.config import PRESETS
    from kivi_tpu_torch.models import modeling
    cfg = dataclasses.replace(PRESETS["llama2-7b"], num_layers=layers)
    return cfg, modeling.init_params(cfg, seed=0, device="cuda")


def parallel_tp(mesh, cfg, params, smi: str) -> dict:
    """(c) Engine(mesh=) at (1, 1) over shard_params of phase_main's
    Llama-2-7B weights and prompts (8 x 1024, 128 greedy tokens): its
    tokens must equal phase_main's unsharded one-shot generate (a
    size-1 group issues no collective)."""
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.kernels import _build
    from kivi_tpu_torch.parallel.mesh import mesh_coords, shard_params
    from kivi_tpu_torch.serving.engine import Engine

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1024), generator=gen,
                           device="cuda")
    _, _, n_model, rank = mesh_coords(mesh)
    eng = Engine(cfg=cfg, qcfg=QuantConfig(2, 2, 32, 128, v_flush=128),
                 max_seq_len=TMAX, batch_size=B,
                 params=shard_params(params, cfg, n_model, rank), mesh=mesh)
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(tokens, 128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"parallel-tp": dict(_build.LAUNCHES)}
    check_launches("parallel-tp", launches["parallel-tp"])
    _equal_tokens(out.cpu(), MAIN_TOKENS["oneshot"], "parallel-tp")
    log(f"[parallel:tp] Engine(mesh=(1, 1)).generate(8 x 1024, 128 greedy) "
        f"over shard_params: {wall:.2f} s, the tokens equal phase_main's "
        f"unsharded one-shot generate; launches {launches['parallel-tp']} "
        f"| card {smi}")
    del eng
    torch.cuda.empty_cache()
    return launches


def parallel_elastic(mesh, cfg, params, layers: int, smi: str) -> dict:
    """(d) ElasticBatcher (8 slots, the batcher cell's 12 requests, all
    greedy) over the main path's Llama-2-7B weights, each step under a
    StepWatchdog that must not fire, recovered onto global_mesh after
    ELASTIC_FAIL steps with requests in flight, over the fp16 cache and
    over KIVI-2: every request completes, every pre-failure stream is a
    prefix of its final one, and the streams made after the recovery are
    held by `_resumed_streams` (over fp16 also to an uninterrupted
    ContinuousBatcher)."""
    import dataclasses
    import functools

    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.kernels import _build
    from kivi_tpu_torch.parallel import multihost
    from kivi_tpu_torch.parallel.elastic import ElasticBatcher, StepWatchdog
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher

    kivi = QuantConfig(2, 2, 32, 128, v_flush=128)
    fp16 = QuantConfig(16, 16, 32, 128)
    launches = {}
    reqs = [dataclasses.replace(r, temperature=0.0, top_p=1.0)
            for r in batcher_requests(12, cfg.vocab_size, seed=5)]
    kw = dict(prompt_buckets=(128, 256, 512, 1024))
    for path, qcfg in (("parallel-elastic-fp16", fp16),
                       ("parallel-elastic", kivi)):
        want = None
        if qcfg is fp16:
            bat = ContinuousBatcher(cfg, qcfg, params, num_slots=B,
                                    max_seq_len=TMAX, **kw)
            want = {u: r.tokens for u, r in bat.run(
                [dataclasses.replace(r) for r in reqs]).items()}
            del bat
            torch.cuda.empty_cache()
        stalls = []
        step_under = functools.partial(StepWatchdog, WATCHDOG_S,
                                       lambda: stalls.append(1))
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eb = ElasticBatcher(cfg, qcfg, params, num_slots=B, max_seq_len=TMAX,
                            mesh=mesh, **kw)
        for r in reqs:
            eb.submit(dataclasses.replace(r))
        for _ in range(ELASTIC_FAIL):
            with step_under():
                eb.step()
        before = {u: list(t) for u, t in eb._emitted.items() if t}
        flight = [u for u, t in before.items()
                  if len(t) < eb._orig[u].max_new_tokens]
        if not flight:
            raise AssertionError(f"{path}: no request in flight at step "
                                 f"{ELASTIC_FAIL}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        resumed = eb.recover(multihost.global_mesh(cfg.num_kv_heads))
        torch.cuda.synchronize()
        rec_ms = (time.perf_counter() - t1) * 1e3
        steps = ELASTIC_FAIL
        while not eb.done:
            with step_under():
                eb.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = dict(_build.LAUNCHES)
        check_launches(path, launches[path])
        got = eb.results()
        n_tok = sum(len(t) for t in got.values())
        if stalls:
            raise AssertionError(f"{path}: the step watchdog fired")
        for r in reqs:
            stream = got[r.uid]
            if len(stream) != r.max_new_tokens:
                raise AssertionError(f"{path}: uid {r.uid} emitted "
                                     f"{len(stream)} of {r.max_new_tokens}")
            pre = before.get(r.uid, [])
            if stream[:len(pre)] != pre:
                raise AssertionError(f"{path}: uid {r.uid}'s pre-failure "
                                     "stream is not a prefix of its final")
        held = _resumed_streams(path, cfg, qcfg, params, reqs, got, want,
                                before, flight,
                                kw["prompt_buckets"] + (TMAX,))
        PARALLEL[path] = dict(recover_ms=rec_ms, tokens_per_s=n_tok / wall,
                              steps=steps, resumed=len(resumed),
                              in_flight=len(flight))
        log(f"[{path}] ElasticBatcher (8 slots, 12 greedy requests, "
            f"{layers} layers, mesh (1, 1)): recover() at step "
            f"{ELASTIC_FAIL} with {len(flight)} requests in flight "
            f"({len(resumed)} resumed) in {rec_ms:.1f} ms; {n_tok} tokens "
            f"in {steps} steps, {n_tok / wall:.1f} generated tokens/s "
            f"(recovery and admissions included); watchdog "
            f"{WATCHDOG_S:.0f} s never fired; "
            + held + f"; launches {launches[path]} | card {smi}")
        del eb
        torch.cuda.empty_cache()
    return launches


def phase_parallel(layers: int, smi: str) -> dict:
    """The parallel tier on one card: (a) the process group and the (1, 1)
    mesh over NCCL, (b) the sequence-parallel prefill at the long slice's
    geometry, (c) the TP/DP engine at (1, 1), (d) the elastic batcher.
    Returns {path: launches}; leaves the mesh in PARALLEL["mesh"] for
    phase 5's (e)."""
    mesh = parallel_group(smi)
    PARALLEL["mesh"] = mesh
    check_ring(smi)
    launches = parallel_seqpar(mesh, layers, smi)
    stamp("parallel-seqpar")
    cfg, params = _parallel_llama2(layers)
    launches.update(parallel_tp(mesh, cfg, params, smi))
    launches.update(parallel_elastic(mesh, cfg, params, layers, smi))
    del params
    torch.cuda.empty_cache()
    return launches


def phase_spec_vs_plain():
    """The speculative verify, card (kernels: row 3's per-row entry)
    against host (plain versions), 2 layers at full width, same weights,
    from the same prefilled state: one width-(k+1) verify's logits over
    the engine's caches with their counters on the device (batch 1, a
    300-token prompt), and over 4 batcher slots admitted at bucketed
    left pads; each slot within phase 5's tolerance of the host."""
    from kivi_tpu_torch.cache import kivi_cache as KC
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.batcher import Request
    from kivi_tpu_torch.serving.engine import Engine
    from kivi_tpu_torch.serving.spec_batcher import SpeculativeBatcher

    cfg, params = _small_model(seed=9)
    cpu_params = {k: ([{n: t.cpu() for n, t in lp.items()} for lp in v]
                      if k == "layers" else v.cpu())
                  for k, v in params.items()}
    kivi = QuantConfig(2, 2, 32, 128, v_flush=128)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(17)
    V, k, bk = cfg.vocab_size, SPEC_K, SPEC_BATCH_K
    prompt = torch.randint(1, V, (1, 300), generator=gen)
    block = torch.randint(1, V, (1, k + 1), generator=gen)
    lens = (100, 256, 150, 201)
    prompts = [torch.randint(1, V, (n,), generator=gen).tolist()
               for n in lens]
    blocks = torch.randint(1, V, (len(lens), bk + 1), generator=gen)
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        eng = Engine(cfg=cfg, qcfg=kivi, params=p, max_seq_len=512,
                     batch_size=1, device=dev)
        _, caches = eng._prefill(prompt.to(dev), eng.own_caches())
        KC.counters_to_device(caches)
        positions = (300 + torch.arange(k + 1, device=dev))[None]
        lg, _ = modeling.forward(p, block.to(dev), caches, cfg, kivi,
                                 positions, mode="extend", last_only=False,
                                 ingest="window")
        bat = SpeculativeBatcher(cfg, kivi, p, cfg, kivi, p,
                                 num_slots=len(lens), max_seq_len=512,
                                 k=bk, device=dev, prompt_buckets=(128, 256))
        for i, pr in enumerate(prompts):
            bat.submit(Request(uid=i, prompt=pr, max_new_tokens=8))
        bat._admit()
        positions = bat.pos + torch.arange(bk + 1, device=dev)
        lg2, _ = modeling.forward(p, blocks.to(dev), bat.caches, cfg, kivi,
                                  positions, mode="extend", last_only=False,
                                  pad_len=bat.pad_dev, active=bat.act_dev,
                                  ingest="window")
        out[dev] = (lg.float().cpu(), lg2.float().cpu())   # synchronizes
        log(f"[plain:spec] {dev}: prefills and the two verifies in "
            f"{time.perf_counter() - t0:.1f} s")
        del eng, bat
    for i, what in enumerate(("engine verify (k+1 = 9)",
                              "batcher verify (k+1 = 5)")):
        card, host = out["cuda"][i], out["cpu"][i]
        for s in range(card.shape[0]):
            err = (card[s] - host[s]).abs().max().item()
            scale = host[s].abs().max().item()
            tol = 5e-2 * scale                   # as phase 5's other paths
            log(f"[plain:spec] 2 layers llama2-7b width, {what}, row {s}: "
                f"logits max|card - host| = {err:.3e} (max|host| "
                f"{scale:.3e}, tolerance {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"spec {what} row {s}: card and host "
                                     "verify logits disagree")
    del params, cpu_params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: main path against the plain path on the host
# ---------------------------------------------------------------------------

def phase_vs_plain():
    import dataclasses

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine

    cfg = dataclasses.replace(PRESETS["llama2-7b"], num_layers=2)
    qcfg = QuantConfig(2, 2, 32, 128, v_flush=128)
    fp16 = QuantConfig(16, 16, 32, 128)
    Bp, prompt, new, tmax = 2, 256, 32, 512
    params = modeling.init_params(cfg, seed=2, device="cuda")
    cpu_params = {k: ([{n: t.cpu() for n, t in lp.items()} for lp in v]
                      if k == "layers" else v.cpu())
                  for k, v in params.items()}
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (Bp, prompt), generator=gen)
    outs, logits, seqpar = {}, {}, {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        eng = Engine(cfg=cfg, qcfg=qcfg, params=p, max_seq_len=tmax,
                     batch_size=Bp, device=dev)
        lg, _ = eng.prefill_chunked(tokens.to(dev), 128)
        logits["chunked", dev] = lg.float().cpu()
        # (e) the sequence-parallel prefill over the (1, 1) mesh: a ring
        # of one, so no collective reaches the host's tensors
        lg, seqpar[dev] = eng.prefill_seqpar(tokens.to(dev),
                                             PARALLEL["mesh"], "data")
        logits["seqpar", dev] = lg.float().cpu()
        lg, _ = eng._prefill(tokens.to(dev))
        logits["oneshot", dev] = lg.float().cpu()
        outs[dev] = eng.generate(tokens.to(dev), new,
                                 prefill_chunk_size=128).cpu()
        eng = Engine(cfg=cfg, qcfg=fp16, params=p, max_seq_len=tmax,
                     batch_size=Bp, device=dev)
        lg, _ = eng._prefill(tokens.to(dev))
        logits["fp16 oneshot", dev] = lg.float().cpu()
    # (e) each layer's K/V stores, card against host (both rings f32),
    # over the filled positions, held as phase_parallel's (b) holds its
    # own: layer 0's packed words >= 99.9% equal (its K/V are one bf16
    # projection of the same embeddings), deeper layers' 2-bit codes
    # >= 95% (the two sides' bf16 matmuls round apart, and a 2-bit code
    # flips at its boundary)
    shares = [_live_codes_equal(a, dataclasses.replace(
        b, k_codes=b.k_codes.cuda(), v_codes=b.v_codes.cuda()), 2)
        for a, b in zip(seqpar["cuda"], seqpar["cpu"])]
    log("[plain] seqpar: each layer's K/V stores card vs host, packed "
        "words / 2-bit codes equal over the filled positions: "
        + ", ".join(f"{w:.5f} / {c:.5f}" for w, c in shares)
        + " (layer 0's words >= 0.999, deeper layers' codes >= 0.95)")
    if not (shares[0][0] >= 0.999
            and min(c for _, c in shares[1:]) >= 0.95):
        raise AssertionError("seqpar: card and host K/V stores disagree")
    del seqpar
    agree = (outs["cuda"] == outs["cpu"]).float().mean().item()
    log(f"[plain] greedy token agreement (chunked, KIVI-2) over {new} "
        f"tokens: {agree:.3f}")
    for path in ("chunked", "oneshot", "fp16 oneshot", "seqpar"):
        card, host = logits[path, "cuda"], logits[path, "cpu"]
        err = (card - host).abs().max().item()
        scale = host.abs().max().item()
        # bf16 activations: the card's and the host's matmuls round their
        # bf16 outputs after differently ordered f32 sums; over two layers
        # that moves logits by a few bf16 ulps of their scale
        tol = 5e-2 * scale
        log(f"[plain] {path}: 2 layers full width, B={Bp}, prompt "
            f"{prompt}: prefill logits max|card - host| = {err:.3e} "
            f"(max|host| {scale:.3e}, tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{path}: card and host prefill logits "
                                 "disagree")


def _counting_routes():
    """Wrap the attention module's split-route kernel wrappers with call
    counters (on either device); returns (counts, restore)."""
    import collections

    from kivi_tpu_torch.core import attention as TA
    counts, saved = collections.Counter(), {}
    for name in SPLIT_KERNELS:
        fn = saved[name] = getattr(TA, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        setattr(TA, name, wrapped)

    def restore():
        for name, fn in saved.items():
            setattr(TA, name, fn)
    return counts, restore


def phase_long_vs_plain():
    """The long slice at 2 layers and full Llama-3.1-8B width, card
    (kernels) against host (plain versions), same weights: a prompt of
    SPLIT_MIN_HISTORY + 1024 tokens (left pad 32) in chunks of 128, in
    the cache bucket that holds it, so that the later chunks take the
    qhist extend route and the decode step the split decode route on
    both sides.  Prefill logits and one decode step's logits (fed the
    card's greedy token on both sides) are compared."""
    import dataclasses

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.core import attention as TA
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine

    cfg = dataclasses.replace(PRESETS["llama3.1-8b"], num_layers=2)
    qcfg = QuantConfig(2, 2, 32, 32)
    n = TA.SPLIT_MIN_HISTORY + 1024
    tmax = next(b for b in (1024, 2048, 4096, 8192, 16384, 32768)
                if n + 1 <= b)               # the LongBench runner's bucket
    params = modeling.init_params(cfg, seed=4, device="cuda")
    cpu_params = {k: ([{n_: t.cpu() for n_, t in lp.items()} for lp in v]
                      if k == "layers" else v.cpu())
                  for k, v in params.items()}
    tokens = long_prompt(n - LPAD, LPAD, cfg.vocab_size, seed=8)
    pos = torch.tensor([[n - LPAD]])
    out, first = {}, None
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        counts, restore = _counting_routes()
        try:
            eng = Engine(cfg=cfg, qcfg=qcfg, params=p, max_seq_len=tmax,
                         batch_size=1, device=dev)
            t0 = time.perf_counter()
            lg, caches = eng.prefill_chunked(tokens.to(dev), 128,
                                             pad_lens=[LPAD])
            if first is None:
                first = lg.argmax(-1).to(torch.int32)[:, None].cpu()
            lg2, _ = eng.decode_step(first.to(dev), pos.to(dev), caches,
                                     pad_lens=[LPAD], flush=True)
            out[dev] = (lg.float().cpu(), lg2.float().cpu())   # synchronizes
        finally:
            restore()
        if not all(counts[k] for k in SPLIT_KERNELS):
            raise AssertionError(f"long vs plain on {dev}: the split routes "
                                 f"did not run: {dict(counts)}")
        log(f"[plain:long] {dev}: prefill of {n} tokens + one decode step "
            f"in {time.perf_counter() - t0:.1f} s, split-route calls "
            f"{dict(counts)}")
    for i, what in enumerate(("prefill", "decode step")):
        card, host = out["cuda"][i], out["cpu"][i]
        err = (card - host).abs().max().item()
        scale = host.abs().max().item()
        tol = 5e-2 * scale                   # as phase 5's other paths
        log(f"[plain:long] 2 layers llama3.1-8b width, B=1, prompt {n} "
            f"(pad {LPAD}), cache {tmax}: {what} logits max|card - host| "
            f"= {err:.3e} (max|host| {scale:.3e}, tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"long: card and host {what} logits "
                                 "disagree")
    del params, cpu_params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the batcher against the engine on the card
# ---------------------------------------------------------------------------

def _small_model(seed: int):
    import dataclasses

    from kivi_tpu_torch.config import PRESETS
    from kivi_tpu_torch.models import modeling
    cfg = dataclasses.replace(PRESETS["llama2-7b"], num_layers=2)
    return cfg, modeling.init_params(cfg, seed=seed, device="cuda")


def phase_batcher_vs_engine():
    """Greedy requests through the batcher (4 slots, bucketed admission)
    against batch-1 Engine runs of the same prompts left-padded to the
    same bucket (pad_lens), as tests/test_batcher.py::_oracle does: the
    first tokens must be equal, and the batcher's first decode step's
    logits of each slot must lie within the phase-5 tolerance of the
    engine's; the agreement of the whole greedy sequences is reported."""
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
    from kivi_tpu_torch.serving.engine import Engine

    cfg, params = _small_model(seed=2)
    tmax, buckets, new = 1024, (128, 256), 48
    gen = torch.Generator(device="cpu")
    gen.manual_seed(6)
    lens = (100, 256, 150, 201)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    for label, qcfg in (("KIVI-2", QuantConfig(2, 2, 32, 128, v_flush=128)),
                        ("fp16", QuantConfig(16, 16, 32, 128))):
        bat = ContinuousBatcher(cfg, qcfg, params, num_slots=len(prompts),
                                max_seq_len=tmax, prompt_buckets=buckets)
        for i, p in enumerate(prompts):
            bat.submit(Request(uid=i, prompt=p, max_new_tokens=new))
        bat.step()                    # admits every request, decodes once
        slot_of = {bat.slot_req[s].uid: s for s in range(bat.S)}
        first = {i: bat.slot_out[slot_of[i]][0] for i in range(len(prompts))}
        step_logits = bat.last_logits.float().cpu()
        while bat.queue or bat.active.any():
            bat.step()
        bat._retire()
        eng = Engine(cfg=cfg, qcfg=qcfg, params=params, max_seq_len=tmax,
                     batch_size=1)
        agree, worst = [], 0.0
        for i, p in enumerate(prompts):
            bucket = next(b for b in buckets if len(p) <= b)
            pad = bucket - len(p)
            toks = torch.tensor([[0] * pad + p], device="cuda")
            logits, caches = eng._prefill(toks, pad_lens=[pad])
            tok0 = int(logits.argmax(-1))
            if tok0 != first[i]:
                raise AssertionError(f"{label} request {i}: first token "
                                     f"{first[i]} != engine's {tok0}")
            lg, _ = eng.decode_step(
                torch.tensor([[tok0]], device="cuda"),
                torch.tensor([[len(p)]], device="cuda"), caches,
                pad_lens=[pad], flush=True)
            lg = lg[0].float().cpu()
            err = (step_logits[slot_of[i]] - lg).abs().max().item()
            tol = 5e-2 * lg.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{label} request {i}: decode logits "
                                     f"max|batcher - engine| {err:.3e} > "
                                     f"{tol:.3e}")
            worst = max(worst, err / lg.abs().max().item())
            want = eng.generate(toks, new, pad_lens=[pad])[0].tolist()
            got = bat.results[i].tokens
            agree.append(sum(a == b for a, b in zip(got, want)) / new)
        log(f"[batcher-vs-engine] {label}, 2 layers full width, "
            f"{len(prompts)} prompts {lens}: first tokens equal; first "
            f"decode step's logits max|batcher - engine| / max|engine| = "
            f"{worst:.3e} (tolerance 5e-2); greedy token agreement over "
            f"{new} tokens per request {[round(a, 3) for a in agree]}")
        del bat, eng
    del params
    torch.cuda.empty_cache()


def _beam_trace(eng, tokens, snap, nb: int, k: int) -> list:
    """The card's beam search behind snap after each of its steps 1..k:
    generate_beam(m) for m = 1..k, all under one graph key (one fill
    bound), so that the replays of run m are the first m steps of run k.
    Returns [(parent rows (N,), tokens (N,), scores (B, nb))] per step."""
    trace = []
    for m in range(1, k + 1):
        eng.generate_beam(tokens, m, num_beams=nb, prefix=snap)
        st = eng._beams[tokens.shape[0], nb]
        trace.append((st.parent.cpu().clone(), st.token[:, 0].cpu().clone(),
                      st.scores.cpu().clone()))
    return trace


def _beam_forced(eng, tokens, snap, nb: int, trace: list) -> list:
    """The host's beam search behind snap, each step's advance forced onto
    the card's parents and tokens (trace), so that both sides hold the
    same histories and the caches are reordered alike.  Returns per step
    (the host's log-probability of each chosen continuation (N,), the
    host's own best nb totals (B, nb), the host's totals of the card's
    choices (B, nb), max|host logits|)."""
    steps, rec = iter(trace), []

    def advance(st, logits, eos):
        parent, token, _ = next(steps)
        B, nb = st.scores.shape
        logp = torch.log_softmax(logits.float(), dim=-1)
        total = st.scores.reshape(-1, 1) + logp          # no EOS: all alive
        chosen = total[parent, token].reshape(B, nb)
        rec.append((logp[parent, token], total.reshape(B, -1).topk(
            nb, dim=-1).values, chosen, logits.abs().max().item()))
        st.scores.copy_(chosen)
        st.parent.copy_(parent)
        st.token.copy_(token[:, None])

    eng._beam_advance = advance
    eng.generate_beam(tokens, len(trace), num_beams=nb, prefix=snap)
    return rec


def check_beam_vs_plain(trace: list, rec: list, nb: int) -> None:
    """The card's replayed beam steps against the host's forced onto the
    same choices: at every step each chosen continuation's log-probability
    (the card's score increment) within 2 x phase 5's tolerance of the
    host's (a log-softmax moves by at most twice its logits' error), and
    the card's choices among the host's best up to a near tie (within
    twice the sum of those tolerances so far); the reorder must have
    moved rows after the first step."""
    N = trace[0][0].numel()
    prev = torch.full((N // nb, nb), NEG_INF)
    prev[:, 0] = 0.0
    worst, bound, moved = 0.0, 0.0, 0
    for i, ((parent, _, scores), (host_inc, best, chosen, scale)) in \
            enumerate(zip(trace, rec)):
        inc = scores.reshape(-1) - prev.reshape(-1)[parent]
        tol = 2 * 5e-2 * scale
        err = (inc - host_inc).abs().max().item()
        bound += tol
        gap = (best - chosen.sort(dim=-1, descending=True).values).max()
        if not (err <= tol and gap.item() <= 2 * bound):
            raise AssertionError(
                f"beam step {i + 1}: card vs host log-probabilities "
                f"max|diff| {err:.3e} (tolerance {tol:.3e}), the card's "
                f"choices {gap.item():.3e} below the host's best (near-tie "
                f"limit {2 * bound:.3e})")
        worst = max(worst, err / tol)
        moved += int(i > 0 and (parent != torch.arange(N)).any())
        prev = scores
    if not moved:
        raise AssertionError("beam: no reorder moved a row after step 1; "
                             "the check saw no reorder")
    log(f"[plain:prefix] beam, {N // nb} x {nb} beams, {len(trace)} "
        f"replayed steps forced alike on the host: log-probabilities of the "
        f"card's choices within {worst:.3f} of the tolerance at worst; "
        f"{moved} steps reordered rows; the card's choices are the host's "
        f"best up to a near tie")


def phase_prefix_vs_plain():
    """The prefix slice at 2 layers and full Llama-2-7B width, card
    (kernels, graphs) against host (plain versions), same weights, KIVI-2:
    a 300-token prefix and 2 suffixes of 64.  The suffix extend's logits
    (generate(prefix=)'s first token) and the teacher-forced logits of
    the longest ragged row after its whole tail are held within phase 5's
    tolerance; on each side the stream must give generate()'s tokens;
    beam search (2 x 2 beams) step by step, the host forced onto the
    card's choices (check_beam_vs_plain); the greedy token agreement of
    the prefix, ragged and stream paths between the two sides is
    reported."""
    import dataclasses

    import numpy as np

    from kivi_tpu_torch.config import PRESETS, QuantConfig
    from kivi_tpu_torch.models import modeling
    from kivi_tpu_torch.serving.engine import Engine

    cfg = dataclasses.replace(PRESETS["llama2-7b"], num_layers=2)
    params = modeling.init_params(cfg, seed=2, device="cuda")
    cpu_params = {k: ([{n: t.cpu() for n, t in lp.items()} for lp in v]
                      if k == "layers" else v.cpu())
                  for k, v in params.items()}
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    system = torch.randint(1, cfg.vocab_size, (300,), generator=gen)
    suffix = torch.randint(1, cfg.vocab_size, (2, 64), generator=gen)
    lens, new, nb, beam_steps = [40, 64], 32, 2, 8
    qcfg = QuantConfig(2, 2, 32, 128, v_flush=128)
    logits, toks = {}, {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        eng = Engine(cfg=cfg, qcfg=qcfg, params=p, max_seq_len=1024,
                     batch_size=2, device=dev)
        snap = eng.prefill_prefix(system)
        suf = suffix.to(dev)
        pr = eng._ingest_prompt(suf, new, prefix=snap)
        logits["prefix", dev] = pr.logits.float().cpu().clone()
        eng.generate(suf, 1, prefix=snap, suffix_lens=lens)
        # a copy: on the host .cpu() is the decode state's own storage,
        # which the next generate() overwrites
        logits["ragged", dev] = eng._dec.logits[
            int(np.argmax(lens))].cpu().clone()
        toks["prefix", dev] = eng.generate(suf, new, prefix=snap).cpu()
        toks["ragged", dev] = eng.generate(suf, new, prefix=snap,
                                           suffix_lens=lens).cpu()
        toks["stream", dev] = torch.from_numpy(np.concatenate(list(
            eng.generate_stream(suf, new, segment=8, prefix=snap)), 1))
        _equal_tokens(toks["stream", dev], toks["prefix", dev],
                      f"stream vs generate on {dev}")
        beng = Engine(cfg=cfg, qcfg=qcfg, params=p, max_seq_len=1024,
                      batch_size=2 * nb, device=dev)
        if dev == "cuda":
            trace = _beam_trace(beng, suf, snap, nb, beam_steps)
        else:
            rec = _beam_forced(beng, suf, snap, nb, trace)
        log(f"[plain:prefix] {dev}: prefix, ragged, stream and beam runs in "
            f"{time.perf_counter() - t0:.1f} s; the stream equals generate")
        del eng, beng, snap
    for what in ("prefix", "ragged"):
        card, host = logits[what, "cuda"], logits[what, "cpu"]
        err = (card - host).abs().max().item()
        scale = host.abs().max().item()
        tol = 5e-2 * scale                   # as phase 5's other paths
        log(f"[plain:prefix] {what}: 2 layers full width, prefix 300, "
            f"suffixes {lens if what == 'ragged' else 64}: logits "
            f"max|card - host| = {err:.3e} (max|host| {scale:.3e}, "
            f"tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"prefix {what}: card and host logits "
                                 "disagree")
    check_beam_vs_plain(trace, rec, nb)
    agree = {w: round((toks[w, "cuda"] == toks[w, "cpu"]).float().mean()
                      .item(), 3) for w in ("prefix", "ragged", "stream")}
    log(f"[plain:prefix] greedy token agreement card vs host over {new} "
        f"tokens: {agree}")
    del params, cpu_params
    torch.cuda.empty_cache()


def prefix_batcher_vs_engine():
    """Batcher requests with prefix_tokens (4 slots, chunks of 128, a
    PrefixCache over a batch-1 engine) against the batch-1 engine's
    generate(prefix=) of the same snapshot, where the admission computes
    what the engine does: KIVI-2 prompts of one whole chunk (one extend
    either way), fp16 prompts of 100-201 tokens (the tail's decode steps
    are exact over the fp cache).  First tokens equal, the first decode
    step's logits within phase 5's tolerance; then the batcher with
    debug=True (every admission forward, tail step and decode step a
    checked call) must give the graphs' tokens on KIVI-2 prompts with
    tails."""
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
    from kivi_tpu_torch.serving.engine import Engine
    from kivi_tpu_torch.serving.prefix_cache import PrefixCache

    cfg, params = _small_model(seed=5)
    tmax, new = 1024, 32
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    system = torch.randint(1, cfg.vocab_size, (300,), generator=gen).tolist()

    def prompts(sizes):
        return [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
                for n in sizes]

    kivi = QuantConfig(2, 2, 32, 128, v_flush=128)
    for label, qcfg, sizes in (("KIVI-2", kivi, (128,) * 4),
                               ("fp16", QuantConfig(16, 16, 32, 128),
                                (100, 128, 150, 201))):
        ps = prompts(sizes)
        eng = Engine(cfg=cfg, qcfg=qcfg, params=params, max_seq_len=tmax,
                     batch_size=1)
        bat = ContinuousBatcher(cfg, qcfg, params, num_slots=len(ps),
                                max_seq_len=tmax, prefill_chunk=128,
                                prefix_cache=PrefixCache(eng))
        for i, p in enumerate(ps):
            bat.submit(Request(uid=i, prompt=p, max_new_tokens=new,
                               prefix_tokens=system))
        bat.step()                    # admits every request, decodes once
        slot_of = {bat.slot_req[s].uid: s for s in range(bat.S)}
        step_logits = bat.last_logits.float().cpu().clone()
        firsts = {i: bat.slot_out[slot_of[i]][0] for i in range(len(ps))}
        while bat.queue or bat.active.any():
            bat.step()
        bat._retire()
        snap = bat.prefix_cache.get(system)
        worst, agree = 0.0, []
        for i, p in enumerate(ps):
            pr = eng._ingest_prompt([p], new, prefix=snap)
            tok0 = int(pr.logits.argmax(-1))
            if tok0 != firsts[i]:
                raise AssertionError(f"{label} prefix request {i}: first "
                                     f"token {firsts[i]} != engine's {tok0}")
            lg, _ = eng.decode_step(
                torch.tensor([[tok0]], device="cuda"),
                torch.tensor([[300 + len(p)]], device="cuda"), pr.caches,
                flush=True)
            lg = lg[0].float().cpu()
            err = (step_logits[slot_of[i]] - lg).abs().max().item()
            if not err <= 5e-2 * lg.abs().max().item():
                raise AssertionError(f"{label} prefix request {i}: decode "
                                     f"logits max|batcher - engine| {err:.3e}")
            worst = max(worst, err / lg.abs().max().item())
            want = eng.generate(torch.tensor([p], device="cuda"), new,
                                prefix=snap)[0].tolist()
            agree.append(sum(a == b for a, b in
                             zip(bat.results[i].tokens, want)) / new)
        log(f"[batcher-vs-engine:prefix] {label}, 2 layers full width, "
            f"prefix 300, prompts {sizes}: first tokens equal; first "
            f"decode step's logits max|batcher - engine| / max|engine| = "
            f"{worst:.3e} (tolerance 5e-2); greedy token agreement over "
            f"{new} tokens {[round(a, 3) for a in agree]}")
        del bat, eng
    ps = prompts((100, 150, 201, 20))
    outs = []
    for debug in (False, True):
        eng = Engine(cfg=cfg, qcfg=kivi, params=params, max_seq_len=tmax,
                     batch_size=1)
        bat = ContinuousBatcher(cfg, kivi, params, num_slots=4,
                                max_seq_len=tmax, prefill_chunk=128,
                                prefix_cache=PrefixCache(eng), debug=debug)
        res = bat.run([Request(uid=i, prompt=p, max_new_tokens=new,
                               prefix_tokens=system)
                       for i, p in enumerate(ps)])
        outs.append([res[i].tokens for i in range(len(ps))])
        del bat, eng
    if outs[0] != outs[1]:
        raise AssertionError("prefix batcher: debug=True tokens differ from "
                             "the graphs'")
    log(f"[batcher-vs-engine:prefix] KIVI-2 prompts {[len(p) for p in ps]} "
        f"behind the prefix (chunks and tails): debug=True tokens equal the "
        f"graphs'")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: ServingAPI on the loopback interface
# ---------------------------------------------------------------------------

def phase_api():
    """Three concurrent POSTs (one streaming) through ServingAPI over a
    2-layer full-width batcher, all answered, then /v1/health."""
    import http.client
    import threading

    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.serving.api import ServingAPI
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher

    cfg, params = _small_model(seed=3)
    bat = ContinuousBatcher(cfg, QuantConfig(2, 2, 32, 128, v_flush=128),
                            params, num_slots=4, max_seq_len=1024,
                            prompt_buckets=(128, 256))
    news = (24, 16, 20)
    out = [None] * 3

    def post(port, i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        prompt = list(range(100 + 37 * i, 250 + 37 * i))
        conn.request("POST", "/v1/generate", json.dumps({
            "prompt": prompt, "max_new_tokens": news[i],
            "stream": i == 1, "temperature": 0.8 if i == 2 else 0.0}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if i == 1:
            toks = []
            for raw in resp:
                line = raw.decode().strip()
                if line == "data: [DONE]":
                    break
                if line.startswith("data: "):
                    toks.append(json.loads(line[6:])["token"])
        else:
            toks = json.loads(resp.read())["tokens"]
        conn.close()
        out[i] = (resp.status, toks)

    t0 = time.perf_counter()
    with ServingAPI(bat) as srv:
        threads = [threading.Thread(target=post, args=(srv.port, i))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/v1/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
    wall = time.perf_counter() - t0
    for i, n in enumerate(news):
        if out[i] is None or out[i][0] != 200 or len(out[i][1]) != n:
            raise AssertionError(f"ServingAPI request {i}: {out[i]}")
    if health["status"] != "ok":
        raise AssertionError(f"ServingAPI health: {health}")
    log(f"[api] ServingAPI on 127.0.0.1: 3 concurrent requests (one "
        f"streamed over SSE) answered with {[len(o[1]) for o in out]} "
        f"tokens in {wall:.2f} s; health {health}")
    del bat, params
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the main-path model (width is never cut)")
    args = ap.parse_args()
    name, smi = phase_card()
    phase_build()
    stamp("build")
    results, crossover = phase_kernels()
    stamp("kernels")
    launches = phase_main(args.layers, smi)
    stamp("main")
    launches.update(phase_prefix(args.layers, smi))
    stamp("prefix")
    launches.update(phase_spec(args.layers, smi))
    stamp("spec")
    launches.update(phase_parallel(args.layers, smi))
    stamp("parallel")
    launches["probe"] = phase_probe()
    stamp("probe")
    phase_vs_plain()
    phase_long_vs_plain()
    phase_prefix_vs_plain()
    phase_spec_vs_plain()
    stamp("vs plain")
    phase_batcher_vs_engine()
    prefix_batcher_vs_engine()
    phase_api()
    stamp("batcher vs engine, api")
    import torch.distributed as dist
    dist.destroy_process_group()
    sources = {
        "quantize_pack_k": ("kivi_tpu_torch/kernels/csrc/quant_pack.cu",
                            "kivi_tpu/kernels/quant_pack.py:119"),
        "quantize_pack_v": ("kivi_tpu_torch/kernels/csrc/quant_pack.cu",
                            "kivi_tpu/kernels/quant_pack.py:177"),
        "flash_extend_attention": (
            "kivi_tpu_torch/kernels/csrc/flash_extend.cu",
            "kivi_tpu/kernels/flash_extend.py:373"),
        # row 3's per-row entry: the same kernel over per-row counters
        "flash_extend_attention_rows": (
            "kivi_tpu_torch/kernels/csrc/flash_extend.cu",
            "kivi_tpu/kernels/flash_extend.py:373"),
        "fused_decode_attention_wide": (
            "kivi_tpu_torch/kernels/csrc/fused_decode.cu",
            "kivi_tpu/kernels/fused_decode_wide.py:544"),
        "fused_decode_attention": (
            "kivi_tpu_torch/kernels/csrc/fused_decode_rows.cu",
            "kivi_tpu/kernels/fused_decode.py:198"),
        "flash_attention": ("kivi_tpu_torch/kernels/csrc/flash.cu",
                            "kivi_tpu/kernels/flash.py:118"),
        "fp_decode_attention_kernel": (
            "kivi_tpu_torch/kernels/csrc/fp_decode.cu",
            "kivi_tpu/kernels/fp_decode.py:84"),
        "qk_dequant_matmul": ("kivi_tpu_torch/kernels/csrc/qk_pv.cu",
                              "kivi_tpu/kernels/qk_pv.py:158"),
        "pv_dequant_matmul": ("kivi_tpu_torch/kernels/csrc/qk_pv.cu",
                              "kivi_tpu/kernels/qk_pv.py:273"),
        "flash_extend_qhist": (
            "kivi_tpu_torch/kernels/csrc/flash_extend_qhist.cu",
            "kivi_tpu/kernels/flash_extend.py:512"),
        "trimmed": ("kivi_tpu_torch/kernels/csrc/trimmed.cu",
                    "scripts/profile_wide_32k.py:243"),
    }
    yardstick = {"flash_attention": "SDPA, causal",
                 "fp_decode_attention_kernel": "SDPA over the live K/V; "
                                               "per-row: with a per-row "
                                               "mask",
                 "fused_decode_attention": "SDPA, per-row mask, over the "
                                           "cache dequantized to bf16",
                 "qk_dequant_matmul": "torch.matmul over the K store "
                                      "dequantized to bf16",
                 "pv_dequant_matmul": "torch.matmul over the V store "
                                      "dequantized to bf16",
                 "flash_extend_qhist": "SDPA over the history dequantized "
                                       "to bf16",
                 "flash_extend_attention_rows": "SDPA, per-row causal "
                                                "mask, over each row's "
                                                "cache dequantized to bf16",
                 "trimmed": "SDPA over the history dequantized to bf16"}
    kernels = []
    for k, (src, rep) in sources.items():
        r = results[k]
        lib = r["library_ms"]
        what = yardstick.get(k, "SDPA over the cache dequantized to bf16")
        yard = ("no library call" if lib is None else
                f"library ({what}) {lib:.4f} ms")
        by_path = {p: n[k] for p, n in launches.items() if n.get(k)}
        total = sum(by_path.values())
        log(f"[time] {k}: {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms "
            f"| bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | {yard} | "
            f"launches {by_path} | card {smi}")
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": total,
                        "launches_by_path": by_path, **r})
    for row in crossover:
        log(f"[time] split vs fused at history {row['fill']} (B={LB}, "
            f"Hkv={LH}, r={LR}, KIVI-2, W=32): decode "
            f"{row['decode_split_ms']:.4f} vs {row['decode_fused_ms']:.4f} "
            f"ms (row 6, t_bound {row['t_bound']}: "
            f"{row['decode_rows_ms']:.4f} ms), extend T1={T1} {row['extend_split_ms']:.4f} vs "
            f"{row['extend_fused_ms']:.4f} ms | card {smi}")
    for path, modes in DECODE.items():
        log(f"[decode] {path}: " + " | ".join(
            f"{mode} {m['tokens_per_s']:.1f} tokens/s, host "
            f"{m['host_ms_per_step']:.3f} ms a step, idle "
            + (f"{m['idle_share']:.4f}" if "idle_share" in m
               else "not measured") for mode, m in modes.items())
            + f" | card {smi}")
    log(f"[decode] {json.dumps(DECODE)}")
    log(f"[spec] {json.dumps(SPEC)} | card {smi}")
    summary = {k: v for k, v in PARALLEL.items() if k != "mesh"}
    log(f"[parallel] {json.dumps(summary)} | card {smi}")
    log(f"[done] {time.perf_counter() - START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
