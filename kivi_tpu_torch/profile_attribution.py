"""Cost attribution of the KIVI decode kernel (row 4) by static ablation,
on one GPU.

    python3 -m kivi_tpu_torch.profile_attribution [--check] [--iters 20]

Port of `scripts/attribution_r5.py`: `fused_decode_attention_wide(
_ablate=...)` takes one part of the kernel's work out at a time
(kernels/fused_decode_wide.py `ABLATIONS`, each a variant of the same
kernel, `kdec::Ablation` of csrc/kdec_split.cuh), and the difference to
the full kernel is that part's cost:

  full      the production kernel (csrc/fused_decode.cu, Ablation<0>)
  window    - the window phase (K window logits, window and strip PV)
  vquant    - the V store's product
  qk        - the store's q . k products (unpack and scales kept)
  kunpack   - the K codes' unpack
  chunk     - the whole quantized-store body (the window phase remains)
  compute   the loads and the dispatch alone (empty bodies)

Rows (attribution_r5.py:64-67): T 4096, B 72, fill 1280 (the serving
fill) and 3968 (a nearly full cache); 32 KV heads, r 1, D 128, KIVI-2
with group 32, a window of W = 128; random packed words and bf16 scales,
minima and windows in [0.01, 0.1) from a seeded generator on the card
(`profile_wide_32k.make_cache`); counters (fill, 128, fill) as the JAX
driver passes them.  The JAX driver also passes a static fill bound
t_bound = 2048 at fill 1280; the port's split plan already stops at
n_k_quant + n_k_win (fused_decode_wide.split_plan), so there is nothing
for it to cut here.

Each variant is timed by `utils.timing.cuda_times` (single calls by CUDA
events after an L2 scrub, the device held busy before each; the median
and the min-max spread of --iters calls), beside the bytes bound of the
full kernel and the card's name and power limit.  Before a row is
timed, every variant is held to its plain version on the very cache it
is timed on (`hold_row`).  --check holds every variant to its plain
version at small shapes and edge states (`check`) and on both rows'
caches, then exits; `main` without it holds and times both rows.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics

import torch

from kivi_tpu_torch import profile_wide_32k as PW
from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.kernels import fused_decode_wide as FD
from kivi_tpu_torch.utils.device import card
from kivi_tpu_torch.utils.timing import cuda_times

ABLATIONS = ("full", "window", "vquant", "qk", "kunpack", "chunk",
             "compute")
ROWS = ((4096, 1280, 72), (4096, 3968, 72))        # (T, fill, B)
GS, W, BITS = PW.GS, PW.W, PW.BITS
RTOL, ATOL = PW.RTOL, PW.ATOL
# check's states over a T = 1024 cache: (n_k_quant, n_k_win, n_v_quant,
# lower bounds of rows 0, 1, ... taken in turn, or None): a window behind
# the store, a strip [n_v_quant, n_k_quant) across a split edge, the
# window alone, a short window, left pads that kill whole splits
CHECK_T = 1024
CHECK_STATES = ((640, 128, 640, None), (640, 60, 576, None),
                (0, 100, 0, None), (1000, 24, 1000, None),
                (768, 100, 740, (0, 300)))


def run(qg, c: KiviLayerCache, ablate: str, lo=None, plain: bool = False):
    """The wide kernel (or its plain version) over the cache under one of
    ABLATIONS -> (B, H, r, D) f32."""
    fn = (FD.fused_decode_attention_wide_plain if plain
          else FD.fused_decode_attention_wide)
    return fn(qg, *PW._stores(c, c.max_seq_len), c.k_win, c.v_win,
              c.n_k_quant, c.n_k_win, c.n_v_quant, group_size=GS,
              k_bits=BITS, v_bits=BITS, lo=lo,
              _ablate=None if ablate == "full" else ablate)


def _with_counters(c: KiviLayerCache, nkq: int, nkw: int, nvq: int):
    return dataclasses.replace(c, n_k_quant=nkq, n_k_win=nkw,
                               n_v_quant=nvq, n_v_win=nkq + nkw - nvq)


def hold(qg, c: KiviLayerCache, what: str, lo=None,
         verbose: bool = True) -> float:
    """Hold every variant over one cache to its plain version on the same
    inputs: within RTOL * max|plain| + ATOL and bit-equal across two
    runs; raise on the first that is not.  Returns the largest
    max|kernel - plain|."""
    worst = 0.0
    for ab in ABLATIONS:
        got = run(qg, c, ab, lo)
        want = run(qg, c, ab, lo, plain=True)
        case = f"{ab} {what}"
        if not torch.equal(got, run(qg, c, ab, lo)):
            raise AssertionError(f"{case}: two runs differ")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del want
        if not (torch.isfinite(got).all() and err <= RTOL * scale + ATOL):
            raise AssertionError(
                f"{case}: max|kernel - plain| {err:.3e} > {RTOL} * "
                f"{scale:.3e} + {ATOL}")
        worst = max(worst, err)
        if verbose:
            print(f"[attr:check] {case}: max|kernel - plain| {err:.3e} "
                  f"(max|plain| {scale:.3e})", flush=True)
    return worst


def check(B: int = 2, heads: int = PW.HKV, device: str = "cuda",
          verbose: bool = True) -> float:
    """Hold every variant to its plain version (`hold`) on CHECK_STATES
    of a T = CHECK_T cache of B rows and `heads` KV heads, on the
    profiler's data and on a peaked one (profile_wide_32k.DATA).
    Returns the largest max|kernel - plain|."""
    worst = 0.0
    for data in PW.DATA:
        qg, c0 = PW.make_cache(B, CHECK_T, CHECK_T - W, heads=heads,
                               device=device, data=data)
        for nkq, nkw, nvq, lo in CHECK_STATES:
            c = _with_counters(c0, nkq, nkw, nvq)
            lo_t = (None if lo is None else torch.tensor(
                [lo[i % len(lo)] for i in range(B)], dtype=torch.int32,
                device=device))
            worst = max(worst, hold(
                qg, c, f"{data} B={B} Hkv={heads} T={CHECK_T} counters "
                       f"({nkq}, {nkw}, {nvq}) lo={lo}", lo_t, verbose))
    return worst


def hold_row(T: int, fill: int, B: int, device: str = "cuda",
             verbose: bool = True) -> float:
    """`hold` on the cache that `profile` times at this row (make_cache is
    seeded: the same data)."""
    qg, c = PW.make_cache(B, T, fill, device=device)
    return hold(qg, c, f"T={T} fill={fill} B={B} Hkv={PW.HKV} counters "
                       f"({c.n_k_quant}, {c.n_k_win}, {c.n_v_quant})",
                verbose=verbose)


def profile(T: int, fill: int, B: int, iters: int, smi: str,
            device: str = "cuda", held: bool = False) -> dict:
    """Hold every variant to its plain version on the row's cache
    (`hold_row`; skipped where the caller has just done so, `held`),
    then time each on that same cache; print the table.  Returns {"T",
    "fill", "B", "bound_ms", "bound_by", "ms": {variant: median},
    "spread": {variant: (min, max)}, "component_ms": {variant: full -
    variant}}."""
    if not held:
        hold_row(T, fill, B, device)
    qg, c = PW.make_cache(B, T, fill, device=device)
    bms, by = PW.attention_bound(qg, c, fill, c.n_k_win)
    print(f"[attr] T={T} fill={fill} B={B} Hkv={PW.HKV} r={PW.R} D={PW.D} "
          f"KIVI-{BITS} group {GS} W={W}, counters ({c.n_k_quant}, "
          f"{c.n_k_win}, {c.n_v_quant}), {iters} calls a variant | card "
          f"{smi}", flush=True)
    ms, spread = {}, {}
    for ab in ABLATIONS:
        times = cuda_times(lambda: run(qg, c, ab), iters=iters)
        ms[ab] = statistics.median(times)
        spread[ab] = (min(times), max(times))
    comp = {ab: ms["full"] - ms[ab] for ab in ABLATIONS if ab != "full"}
    for ab in ABLATIONS:
        lo, hi = spread[ab]
        tail = (f"bound {bms:.4f} ms ({by}), {ms[ab] / bms:.1f}x"
                if ab == "full" else
                f"component (full - {ab}) {comp[ab]:+.4f} ms of "
                f"{ms['full']:.4f}")
        print(f"[attr]   {ab:8s} {ms[ab]:8.4f} ms (min {lo:.4f}, max "
              f"{hi:.4f}) | {tail} | card {smi}", flush=True)
    return dict(T=T, fill=fill, B=B, bound_ms=bms, bound_by=by, ms=ms,
                spread=spread, component_ms=comp)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="hold every variant to its plain version at "
                         "small shapes and on both rows' caches, and exit")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls a variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_attribution: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.check:
        check()
        for T, fill, B in ROWS:
            hold_row(T, fill, B)
        return []
    smi = card()
    return [profile(T, fill, B, args.iters, smi) for T, fill, B in ROWS]


if __name__ == "__main__":
    main()
