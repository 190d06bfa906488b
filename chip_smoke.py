#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kivi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases (any failure raises; the exit code is then non-zero):
  1. card: name, and power limit as nvidia-smi reports it;
  2. build: compile every CUDA kernel from kivi_tpu_torch/kernels/csrc;
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes and edge cases, timed with CUDA events beside their
     bound and a one-call PyTorch yardstick; the split routes (split
     decode, qhist extend) against the fused kernels on the same inputs
     at the long slice's geometry, timed at fills of 1K, 4K and 12K (the
     crossover behind core.attention.SPLIT_MIN_HISTORY); the probe
     path's kernels by the profiler's checker (profile_wide_32k.check):
     every variant of the decode ablation probe (kernels/trimmed.py),
     the wide kernel and the split decode route, at small shapes and at
     the probe path's own 32K geometry, on a flat and a peaked softmax;
  4. the paths at Llama-2-7B width, sharing one set of weights:
     Engine.generate of 8 prompts of 1024 tokens, 128 greedy tokens,
       * KIVI-2, chunked prefill of 128 (extend + KIVI decode),
       * KIVI-2, one-shot prefill (flash_attention + ingest + decode),
       * the fp16 cache, one-shot prefill (flash_attention + fp decode);
     each path's kernels must launch during its run (counts zeroed just
     before it), and a split prefill + decode must give generate()'s
     tokens;
     then the continuous batcher at the same width on the same weights
     (8 slots, 12 requests of 100-1000 prompt tokens and 16-128 new
     tokens, half greedy, half sampled), three ways:
       * KIVI-2, bucketed one-shot admission (per-row KIVI decode),
       * KIVI-2, chunked admission (prefill_chunk=128),
       * the fp16 cache, bucketed admission (fp decode, per-row lengths);
     each path's kernels must launch and the engine's decode kernel must
     not;
     then the long-context slice at Llama-3.1-8B width: Engine.generate
     at batch 1 of a 12,000-token prompt left-padded to 12,032, chunks
     of 128, a 16,384-token cache, KIVI-2 with group 32 and residual 32
     (the reference's example configuration), 64 greedy tokens; the
     split routes' kernels must launch and the fused decode kernels
     must not;
     then the probe path: `python3 -m kivi_tpu_torch.profile_wide_32k
     --quick` (B = 4, 32 KV heads, a 32K history), whose wide kernel,
     split decode route and probe variants must launch;
  5. the paths against the plain path: 2 layers at full width on the
     card (kernels) and on the host CPU (plain versions), same weights:
     chunked and one-shot prefill logits of both caches; the long slice
     with a prompt of SPLIT_MIN_HISTORY + 1024 tokens (prefill and one
     decode step's logits, both split routes on both sides);
  6. the batcher against the engine on the card (2 layers, full width):
     first tokens equal and one decode step's logits per slot within the
     phase-5 tolerance of batch-1 Engine runs of the same left-padded
     prompts, on both caches;
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
    from kivi_tpu_torch.utils.device import card
    from kivi_tpu_torch.utils.timing import bound, cuda_ms
except ModuleNotFoundError as e:
    # run alone, without the package it drives: fail with no result
    raise SystemExit(f"chip_smoke: {e}; run it from the root of a checkout "
                     "of the repository") from None

# Attention tolerance on the card: max|kernel - plain| <= ATT_RTOL *
# max|plain| + ATT_ATOL.  Tighter than bf16 rounding on purpose: the
# kernels and the plain versions both dequantize and compute in f32
# from the same bf16 inputs (TF32 off), so they differ only in
# summation order and fused multiply-adds, about 1e-7 relative.
ATT_RTOL, ATT_ATOL = 1e-5, 1e-5
B, H, D, TMAX, T1 = 8, 32, 128, 4096, 128
# per-slot fills of the per-row decode checks: divergent, 0 = empty slot
FILLS = (1, 137, 640, 1081, 2048, 3000, 4000, 0)
# the long-context slice: Llama-3.1-8B's attention (8 KV heads, 4 query
# rows each) at batch 1, a 16K cache holding a 12,032-token prompt
LB, LH, LR, LTMAX, LFILL, LPAD, LNEW = 1, 8, 4, 16384, 12032, 32, 64
CROSS_FILLS = (1024, 2048, 4096, 8192, 12032)   # split vs fused timings
NEG_INF = -1e30


def log(*a):
    print(*a, flush=True)


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
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_quant(gen, results):
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
        # timed at the main path's shape: one 128-token chunk or flush
        x = _randn(gen, (B, H, 128, D))
        Dw = D // 16
        nbytes = (x.numel() * 2 + B * H * Dw * 128 * 4
                  + 2 * B * H * (128 // gs) * D * 4)
        bms, by = bound(nbytes, 0)
        results[name] = dict(
            max_abs_err=worst, ms=cuda_ms(lambda: kern(x, gs, 2)),
            plain_ms=cuda_ms(lambda: plain(x, gs, 2)), bound_ms=bms,
            bound_by=by, library_ms=None)


def _filled_cache(gen, qcfg, fill: int, heads: int = H, batch: int = B,
                  tmax: int = TMAX):
    """A (batch, heads, D, tmax) cache holding `fill` tokens, the last one
    just appended by decode_append (the state decode attention reads)."""
    from kivi_tpu_torch.cache import kivi_cache as KC
    c = KC.init_layer_cache(batch, heads, D, tmax, qcfg, device="cuda")
    if fill > 1:
        KC.prefill_ingest(c, _randn(gen, (batch, heads, fill - 1, D)),
                          _randn(gen, (batch, heads, fill - 1, D)), qcfg)
    KC.decode_append(c, _randn(gen, (batch, heads, 1, D)),
                     _randn(gen, (batch, heads, 1, D)), qcfg)
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


def check_decode(gen, results):
    import torch.nn.functional as F

    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.kernels import fused_decode_wide as FD
    name = "fused_decode_attention_wide"
    worst = 0.0
    # (bits, v_flush, fill, mask, KV heads, query rows per KV head)
    cases = [(bits, 128, fill, None, H, 1) for bits in (2, 4, 8)
             for fill in (1, 1024 + 57, TMAX)]
    cases += [(2, 32, 1024 + 57, None, H, 1),     # n_v_quant < n_k_quant
              (2, 128, 1024 + 57, "pad", H, 1),
              (4, 32, 1024 + 57, "swa", H, 1),     # lo = seq_len - 1000
              (2, 128, 1024 + 57, "pad", 8, 4)]    # Llama-3 GQA geometry
    timed = None
    for bits, vf, fill, mask, heads, r in cases:
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf)
        c = _filled_cache(gen, qcfg, fill, heads)
        q = _randn(gen, (B, heads, r, D))
        lo = None
        if mask == "pad":
            lo = torch.arange(B, device="cuda", dtype=torch.int32) * 37
        elif mask == "swa":
            lo = torch.full((B,), c.seq_len - 1000, device="cuda",
                            dtype=torch.int32)
        args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.k_win, c.v_win, c.n_k_quant, c.n_k_win,
                c.n_v_quant)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, lo=lo)
        got = FD.fused_decode_attention_wide(*args, **kw)
        want = FD.fused_decode_attention_wide_plain(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _att_err(
            got, want, f"{name} bits={bits} vf={vf} fill={fill} "
                       f"mask={mask} Hkv={heads} r={r} "
                       f"(nkq={c.n_k_quant} nvq={c.n_v_quant})"))
        if (bits, vf, fill, mask, r) == (2, 128, 1024 + 57, None, 1):
            timed = (c, qcfg, args, kw, q)
    c, qcfg, args, kw, q = timed
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
    # (bits, v_flush, KV heads, query rows per KV head, lower bound); the
    # batcher's main path runs the first
    cases = [(2, 128, H, 1, None)]
    cases += [(bits, 32, heads, r, "pad") for bits in (2, 4, 8)
              for heads, r in ((H, 1), (8, 4))]
    cases += [(4, 32, H, 1, "swa"), (8, 128, 8, 4, "swa")]
    timed = None
    for bits, vf, heads, r, mask in cases:
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf)
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
        got = FR.fused_decode_attention(*args, **kw)
        want = FR.fused_decode_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        what = (f"{name} bits={bits} vf={vf} Hkv={heads} r={r} mask={mask}"
                f" fills={FILLS}")
        worst = max(worst, _att_err(got, want, what))
        if got[FILLS.index(0)].abs().max() != 0:
            raise AssertionError(f"{what}: the empty row is not 0")
        log(f"[kernel] {what}: empty row exactly 0; (n_k_quant, n_k_win, "
            f"n_v_quant) per row {[x[:3] for x in rows]}")
        if (bits, vf, r, mask) == (2, 128, 1, None):
            timed = (c, qcfg, args, kw, q, rows)
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

    c, qcfg, args, kw, q, rows = timed
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
    # v_flush); the main path's chunks see fills 0, 128, ..., 896
    cases = [(0, None, 0, H, 1, 2, 128), (128, None, 0, H, 1, 2, 128),
             (896, None, 0, H, 1, 2, 128), (128, 200, 0, H, 1, 2, 128),
             (0, 60, 0, H, 1, 2, 128),
             (200, None, 100, H, 1, 4, 32),      # sliding window
             (384, 150, 0, 8, 4, 8, 32)]         # Llama-3 GQA, 8-bit
    for fill, pad, sw, heads, r, bits, vf in cases:
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf)
        c = KC.init_layer_cache(B, heads, D, TMAX, qcfg, device="cuda")
        if fill:
            KC.prefill_ingest(c, _randn(gen, (B, heads, fill, D)),
                              _randn(gen, (B, heads, fill, D)), qcfg)
        q = _randn(gen, (B, heads, r * T1, D))
        kn = _randn(gen, (B, heads, T1, D))
        vn = _randn(gen, (B, heads, T1, D))
        pad_len = None
        if pad is not None:
            pad_len = torch.full((B,), pad, device="cuda",
                                 dtype=torch.int32)
            pad_len[0] = 0
        args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.k_win, c.v_win, kn, vn, c.n_k_quant, c.n_k_win,
                c.n_v_quant)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=T1,
                  sliding_window=sw, pad_len=pad_len)
        got = FE.flash_extend_attention(*args, **kw)
        want = FE.flash_extend_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _att_err(
            got, want, f"{name} fill={fill} pad={pad} window={sw} "
                       f"Hkv={heads} r={r} bits={bits} vf={vf}"))
        if (fill, pad, sw, r) == (896, None, 0, 1):
            timed = (c, args, kw, q, kn, vn)
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
    16K cache filled to 12K), bits 2/4/8, r 1/4/8, n_quant 0, partial,
    the cache's and all of T; then timed at the slice's shapes."""
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.core import quant as Q
    from kivi_tpu_torch.kernels import qk_pv as QP
    worst = {"qk_dequant_matmul": 0.0, "pv_dequant_matmul": 0.0}
    pos = torch.arange(LTMAX, device="cuda")
    timed = None
    for bits, r in ((2, 4), (2, 1), (2, 8), (4, 4), (8, 4)):
        qcfg = QuantConfig(bits, bits, 32, 32)
        c = _filled_cache(gen, qcfg, LFILL + 1, LH, LB, LTMAX)
        q = _randn(gen, (LB, LH, r, D))
        kargs = (c.k_codes, c.k_scale, c.k_mn, 32, bits)
        vargs = (c.v_codes, c.v_scale, c.v_mn, 32, bits)
        for nq in (0, 5017, c.n_k_quant, LTMAX):
            what = f"bits={bits} r={r} n_quant={nq}"
            got = QP.qk_dequant_matmul(q, *kargs, n_quant=nq)
            want = QP.qk_dequant_matmul_plain(q, *kargs, n_quant=nq)
            torch.cuda.synchronize()
            worst["qk_dequant_matmul"] = max(
                worst["qk_dequant_matmul"],
                _logit_err(got, want, nq, f"qk_dequant_matmul {what}"))
            # p: a softmax over the first nq positions, exactly 0 past them
            p = torch.zeros((LB, LH, r, LTMAX), device="cuda")
            if nq:
                p = torch.softmax(torch.randn(
                    p.shape, generator=gen, device="cuda").masked_fill(
                        pos >= nq, float("-inf")), dim=-1)
            got = QP.pv_dequant_matmul(p, *vargs, n_quant=nq)
            want = QP.pv_dequant_matmul_plain(p, *vargs, n_quant=nq)
            again = QP.pv_dequant_matmul(p, *vargs, n_quant=nq)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"pv_dequant_matmul {what}: two runs "
                                     "differ")
            worst["pv_dequant_matmul"] = max(
                worst["pv_dequant_matmul"],
                _att_err(got, want, f"pv_dequant_matmul {what} (two runs "
                                    "bit-equal)"))
        if (bits, r) == (2, LR):
            timed = (c, q, kargs, vargs)

    c, q, kargs, vargs = timed
    nkq, nvq = c.n_k_quant, c.n_v_quant
    p = torch.softmax(torch.randn((LB, LH, LR, LTMAX), generator=gen,
                                  device="cuda").masked_fill(
        pos >= nkq, float("-inf")), dim=-1).masked_fill(pos >= nvq, 0.0)
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


def _state_err(got, want, what: str) -> float:
    """A flash state (acc, m, l) against the plain one: rows with no
    admitted position are (0, NEG_INF, 0) in both; the rest within the
    attention tolerance."""
    acc, m, l = got
    acc_w, m_w, l_w = want
    empty = m_w == NEG_INF
    if not (torch.equal(m == NEG_INF, empty) and (l[empty] == 0).all()
            and (acc[empty] == 0).all()):
        raise AssertionError(f"{what}: empty rows are not (0, -1e30, 0)")
    err = 0.0
    if not empty.all():
        err = max(_att_err(acc, acc_w, f"{what} acc"),
                  _att_err(m[~empty], m_w[~empty], f"{what} m"),
                  _att_err(l, l_w, f"{what} l"))
    log(f"[kernel] {what}: {int(empty.sum())} rows see no history, "
        "exactly (0, -1e30, 0)")
    return err


def check_qhist(gen, results):
    """Row 5 against its plain version: the slice's geometry, an empty
    history, bits 2/4/8, n_k_quant > n_v_quant, per-row pads (one past
    the history) and a sliding window; timed at the slice's shapes."""
    import torch.nn.functional as F

    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.kernels import flash_extend as FE
    name = "flash_extend_qhist"
    worst, timed = 0.0, None
    # (history, pads, sliding window, bits, W, v_flush)
    cases = [(LFILL, None, 0, 2, 32, 32),        # the slice
             (0, None, 0, 2, 32, 32),            # empty history
             (3000, None, 0, 4, 32, 32), (3000, None, 0, 8, 32, 32),
             (2200, None, 0, 2, 128, 32),        # n_k_quant > n_v_quant
             (3000, (0, 700), 0, 2, 32, 32),
             (3000, (32, 3050), 0, 2, 32, 32),   # row 1 sees nothing
             (3000, None, 1000, 4, 32, 32)]      # sliding window
    for fill, pads, sw, bits, W, vf in cases:
        qcfg = QuantConfig(bits, bits, 32, W, v_flush=vf)
        batch = 1 if pads is None else len(pads)
        c = _ingested_cache(gen, qcfg, fill, batch=batch)
        qg = _randn(gen, (batch, LH, LR * T1, D))
        pad_len = (None if pads is None else
                   torch.tensor(pads, device="cuda", dtype=torch.int32))
        args = (qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                c.v_mn, c.v_win, c.n_k_quant, c.n_v_quant, c.seq_len)
        kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=T1,
                  sliding_window=sw, pad_len=pad_len)
        got = FE.flash_extend_qhist(*args, **kw)
        want = FE.flash_extend_qhist_plain(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _state_err(
            got, want, f"{name} history={fill} pads={pads} window={sw} "
                       f"bits={bits} W={W} vf={vf} (nkq={c.n_k_quant} "
                       f"nvq={c.n_v_quant})"))
        if fill == LFILL:
            timed = (c, qcfg, args, kw, qg)
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
    pv_dequant_matmul) vs fused_decode_attention_wide; extend (T1 = 128):
    the qhist route (flash_extend_qhist + torch merge) vs
    flash_extend_attention.  Both pairs compute one function in f32, so
    the tolerance is the kernels' (ATT_RTOL, ATT_ATOL)."""
    from kivi_tpu_torch.config import QuantConfig
    from kivi_tpu_torch.core import attention as TA
    from kivi_tpu_torch.kernels import flash_extend as FE
    from kivi_tpu_torch.kernels import fused_decode_wide as FD
    qcfg = QuantConfig(2, 2, 32, 32)
    pad = torch.full((LB,), LPAD, device="cuda", dtype=torch.int32)
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
        dec = (cuda_ms(lambda: FD.fused_decode_attention_wide(*args, **kw)),
               cuda_ms(lambda: TA._decode_attention_split(q, c, qcfg, pad)))

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
        _att_err(full, eplain, f"flash_extend_attention {geo} T1={T1} "
                               f"history={fill} vs its plain version")
        _att_err(routed, full, f"qhist extend route vs flash_extend_"
                               f"attention, {geo} T1={T1} history={fill}")
        ext = (cuda_ms(lambda: FE.flash_extend_attention(*eargs, **ekw)),
               cuda_ms(qhist_route))
        crossover.append(dict(fill=fill, decode_fused_ms=dec[0],
                              decode_split_ms=dec[1],
                              extend_fused_ms=ext[0],
                              extend_split_ms=ext[1]))
        log(f"[crossover] history {fill}: decode fused {dec[0]:.4f} ms, "
            f"split {dec[1]:.4f} ms | extend (T1={T1}) fused {ext[0]:.4f} "
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
        # the kernel rounds its f32 result to bf16 once: one bf16 ulp
        # (2^-8 relative) of the largest output, plus summation order
        err = (got.float() - want).abs().max().item()
        scale = want.abs().max().item()
        if not (torch.isfinite(got).all() and err <= 2.0 ** -8 * scale
                + 1e-5):
            raise AssertionError(f"{what}: max|kernel - plain| = "
                                 f"{err:.3e} > 2^-8 * {scale:.3e} + 1e-5")
        log(f"[kernel] {what}: max|kernel - plain| = {err:.3e} "
            f"(max|plain| {scale:.3e})")
        worst = max(worst, err)
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
            timed = (q, k, v)
    q, k, v = timed
    nbytes = 4 * q.numel() * 2                       # q, k, v, out bf16
    bms, by = bound(nbytes, 4 * B * H * D * T * (T + 1) // 2)
    results[name] = dict(
        max_abs_err=worst, ms=cuda_ms(lambda: FL.flash_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: FL.flash_attention_plain(q, k, v)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)))
    log(f"[kernel] {name} timed at B={B}, H={H}, T={T}, D={D}, causal")


def check_fp_decode(gen, results):
    import torch.nn.functional as F

    from kivi_tpu_torch.cache import fp_cache as FC
    from kivi_tpu_torch.kernels import fp_decode as FD
    name = "fp_decode_attention_kernel"
    worst = 0.0
    # (fill, KV heads, query rows per KV head, mask)
    cases = [(1, H, 1, None), (1081, H, 1, None), (TMAX, H, 1, None),
             (1081, 8, 4, None), (1081, H, 1, "pad"), (1081, H, 1, "swa")]
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
        torch.cuda.synchronize()
        worst = max(worst, _att_err(
            got, want, f"{name} fill={fill} Hkv={heads} r={r} "
                       f"mask={mask}"))
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
        torch.cuda.synchronize()
        what = (f"{name} per-row lengths {FILLS} Hkv={heads} r={r} "
                f"mask={mask}")
        worst = max(worst, _att_err(got, want, what))
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
    log(f"[kernel] {name} per-row lengths {FILLS}: {rows_ms:.4f} ms, bound "
        f"{rows_bms:.4f} ms")
    del c_rows, rows

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
        rows_ms=rows_ms, rows_bound_ms=rows_bms)
    log(f"[kernel] {name} timed at fill {fill}, B={B}, H={H}, r=1")


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    check_quant(gen, results)
    check_decode(gen, results)
    check_fused_decode_rows(gen, results)
    check_extend(gen, results)
    check_flash(gen, results)
    check_fp_decode(gen, results)
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
                "fused_decode_attention_wide",
                "fused_decode_attention") + SPLIT_KERNELS
PROBE = ("trimmed",)        # the ablation probe runs on the probe path only
# path -> (kernels that must launch, kernels that must not)
PATHS = {
    "chunked": (KIVI_KERNELS[:4],
                ("fused_decode_attention",) + SPLIT_KERNELS + PROBE),
    "oneshot": (("flash_attention", "quantize_pack_k", "quantize_pack_v",
                 "fused_decode_attention_wide"),
                ("fused_decode_attention",) + SPLIT_KERNELS + PROBE),
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
    "long": (("quantize_pack_k", "quantize_pack_v") + SPLIT_KERNELS,
             ("fused_decode_attention_wide", "fused_decode_attention",
              "fp_decode_attention_kernel", "flash_attention") + PROBE),
    # the 32K ablation profiler: the wide kernel and the split decode
    # route as anchors, then every variant of the probe
    "probe": (PROBE + ("fused_decode_attention_wide", "qk_dequant_matmul",
                       "pv_dequant_matmul"),
              ("quantize_pack_k", "quantize_pack_v", "flash_extend_attention",
               "fused_decode_attention", "flash_extend_qhist",
               "flash_attention", "fp_decode_attention_kernel")),
}


def check_launches(path: str, launches: dict) -> None:
    must, must_not = PATHS[path]
    for k in must:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{path} path never launched {k}")
    for k in must_not:
        if launches.get(k, 0):
            raise AssertionError(f"{path} path launched {k}")


def run_path(path: str, eng, tokens, new: int, smi: str,
             chunk=None, pad_lens=None) -> dict:
    """generate() with the launch counts zeroed just before and read just
    after; then the same path split into prefill and decode, timed, whose
    tokens must equal generate()'s: two greedy runs of the same kernels
    on the same weights, prompt and card.  chunk: the prefill chunk
    (None = one-shot); pad_lens: the rows' left pads."""
    from kivi_tpu_torch.kernels import _build
    Bn, prompt = tokens.shape
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(tokens, new, prefill_chunk_size=chunk,
                       pad_lens=pad_lens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"[main:{path}] generate({Bn}x{prompt}, {new} new): {wall:.2f} s, "
        f"launches {launches}")
    check_launches(path, launches)
    if out.shape != (Bn, new) or out.min() < 0 or \
            out.max() >= eng.cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {tuple(out.shape)}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if chunk is None:
        first, caches = eng.prefill(tokens, pad_lens=pad_lens)
    else:
        logits, caches = eng.prefill_chunked(tokens, chunk,
                                             pad_lens=pad_lens)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        first = logits.argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pos = torch.full((Bn, 1), prompt, device="cuda")
    if pad_lens is not None:
        pos = pos - torch.tensor(pad_lens, device="cuda")[:, None]
    t0 = time.perf_counter()
    rest, caches = eng.decode(first, pos, caches, steps=new - 1,
                              prompt_len=prompt, pad_lens=pad_lens)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    last, _ = eng.decode_step(rest[:, -1:], pos + new - 1, caches,
                              pad_lens=pad_lens, flush=True)
    if not torch.isfinite(last).all():
        raise AssertionError("non-finite decode logits")
    split = torch.cat([first, rest], 1)
    if not torch.equal(split, out):
        bad = (split != out).any(dim=0).nonzero()
        raise AssertionError(
            f"{path}: split prefill + decode tokens differ from generate() "
            f"from step {int(bad[0])} on")
    tps = Bn * (new - 1) / t_dec
    log(f"[main:{path}] prefill {Bn}x{prompt}"
        f"{f' (chunks of {chunk})' if chunk else ' (one-shot)'}"
        f"{f', left pads {pad_lens}' if pad_lens else ''}: {t_pre:.3f} s | "
        f"decode {new - 1} steps: {t_dec:.3f} s = {tps:.1f} tokens/s | "
        f"{eng.cfg.num_layers} layers | card {smi}")
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


def run_batcher(path: str, bat, reqs, smi: str) -> dict:
    """Drive the batcher over reqs with the launch counts zeroed just
    before and read just after; every request must come back with its
    max_new_tokens valid token ids."""
    from kivi_tpu_torch.kernels import _build
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
        f"tokens/s | {bat.cfg.num_layers} layers | card {smi}")
    log(f"[main:{path}] launches {launches}")
    return launches


def phase_main(layers: int, smi: str) -> dict:
    """Engine.generate on three paths, then the continuous batcher on
    three, all on one set of Llama-2-7B weights; then the long slice on
    Llama-3.1-8B weights.  Returns {path: {kernel: launches}}."""
    import dataclasses

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
        launches[path] = run_path(path, eng, tokens, new, smi,
                                  chunk=128 if path == "chunked" else None)
        del eng
        torch.cuda.empty_cache()
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher
    for path, qcfg, chunk in (("batcher", kivi, 0),
                              ("batcher-chunked", kivi, 128),
                              ("batcher-fp16", fp16, 0)):
        bat = ContinuousBatcher(cfg, qcfg, params, num_slots=B,
                                max_seq_len=TMAX,
                                prompt_buckets=(128, 256, 512, 1024),
                                prefill_chunk=chunk)
        launches[path] = run_batcher(
            path, bat, batcher_requests(12, cfg.vocab_size, seed=5), smi)
        del bat
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    launches["long"] = phase_long(layers, smi)
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
    launches = run_path("long", eng, tokens.cuda(), LNEW, smi, chunk=128,
                        pad_lens=[LPAD])
    del eng, params
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
    outs, logits = {}, {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        eng = Engine(cfg=cfg, qcfg=qcfg, params=p, max_seq_len=tmax,
                     batch_size=Bp, device=dev)
        lg, _ = eng.prefill_chunked(tokens.to(dev), 128)
        logits["chunked", dev] = lg.float().cpu()
        lg, _ = eng._prefill(tokens.to(dev))
        logits["oneshot", dev] = lg.float().cpu()
        outs[dev] = eng.generate(tokens.to(dev), new,
                                 prefill_chunk_size=128).cpu()
        eng = Engine(cfg=cfg, qcfg=fp16, params=p, max_seq_len=tmax,
                     batch_size=Bp, device=dev)
        lg, _ = eng._prefill(tokens.to(dev))
        logits["fp16 oneshot", dev] = lg.float().cpu()
    agree = (outs["cuda"] == outs["cpu"]).float().mean().item()
    log(f"[plain] greedy token agreement (chunked, KIVI-2) over {new} "
        f"tokens: {agree:.3f}")
    for path in ("chunked", "oneshot", "fp16 oneshot"):
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
    t_start = time.perf_counter()
    name, smi = phase_card()
    phase_build()
    results, crossover = phase_kernels()
    launches = phase_main(args.layers, smi)
    launches["probe"] = phase_probe()
    phase_vs_plain()
    phase_long_vs_plain()
    phase_batcher_vs_engine()
    phase_api()
    sources = {
        "quantize_pack_k": ("kivi_tpu_torch/kernels/csrc/quant_pack.cu",
                            "kivi_tpu/kernels/quant_pack.py:119"),
        "quantize_pack_v": ("kivi_tpu_torch/kernels/csrc/quant_pack.cu",
                            "kivi_tpu/kernels/quant_pack.py:177"),
        "flash_extend_attention": (
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
                 "fp_decode_attention_kernel": "SDPA over the live K/V",
                 "fused_decode_attention": "SDPA, per-row mask, over the "
                                           "cache dequantized to bf16",
                 "qk_dequant_matmul": "torch.matmul over the K store "
                                      "dequantized to bf16",
                 "pv_dequant_matmul": "torch.matmul over the V store "
                                      "dequantized to bf16",
                 "flash_extend_qhist": "SDPA over the history dequantized "
                                       "to bf16",
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
            f"ms, extend T1={T1} {row['extend_split_ms']:.4f} vs "
            f"{row['extend_fused_ms']:.4f} ms | card {smi}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
