"""Ablation profiler of the KIVI decode kernel at a 32K history, on one GPU.

    python3 -m kivi_tpu_torch.profile_wide_32k [--quick] [--B 4]
        [--T 32768] [--fill 32640] [--check]

Port of `scripts/profile_wide_32k.py`.  The geometry is the JAX
script's: MHA with 32 KV heads, one query row each, head_dim 128, KIVI-2
with group 32, a T-position cache of random packed words and bf16
scales and minima in [0.01, 0.1) from a seeded generator on the card,
in the port's layout; `fill` quantized positions, and (for the anchors)
a window of the 128 newest tokens.  The times do not depend on the
data.

Times, by `utils.timing.bench_fn` (CUDA events, two loop lengths
differenced, minimum of 3 repeats; --quick: 5 calls a loop, else 20):

  * anchors: the port's wide decode kernel (`fused_decode_attention_wide`,
    counters (fill, 128, fill) as the JAX anchor), and the decode route
    `core.attention.decode_attention` takes at this geometry (at B = 4,
    4 * 32 = 128 blocks < 132 SMs over a history >= SPLIT_MIN_HISTORY:
    the split route, `qk_dequant_matmul` + softmax + `pv_dequant_matmul`);
  * each variant of `kernels.trimmed` (its VARIANTS), the wide kernel's
    body at full fill with one part of the work taken out at a time.

Each line gives the time, the least time the card could take for the
item's inputs (bytes over 3.35 TB/s), and the card's name and power
limit.  --check instead runs `check` on that cache and on one quantized
from normal keys and values (a peaked softmax), then exits.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import attention as TA
from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import fused_decode_wide as FD
from kivi_tpu_torch.kernels import trimmed as TR
from kivi_tpu_torch.utils.device import card
from kivi_tpu_torch.utils.profiling import memory_snapshot, tensor_bytes
from kivi_tpu_torch.utils.timing import bench_fn, bound

HKV, R, D, GS, W, BITS = 32, 1, 128, 32, 128, 2
# attention tolerance on the card (chip_smoke.py's ATT_RTOL / ATT_ATOL)
RTOL, ATOL = 1e-5, 1e-5
# make_cache's data: "uniform" (the profiler's) and "normal" (a peaked
# softmax, so that a wrong QK or rescale misses by orders of magnitude)
DATA = ("uniform", "normal")
Q_STD = 3.0        # "normal": std of the logits q . k / sqrt(D)


def qcfg(bits: int = BITS) -> QuantConfig:
    return QuantConfig(bits, bits, GS, W, v_flush=W)


def variant_name(scales: str, do_qk: bool, do_vpath: bool,
                 do_unpack: bool) -> str:
    off = [n for n, on in (("QK", do_qk), ("V path", do_vpath),
                           ("unpack", do_unpack)) if not on]
    return f"trimmed scales={scales}" + (f", no {', no '.join(off)}"
                                         if off else "")


def make_cache(B: int, T: int, fill: int, *, heads: int = HKV,
               r: int = R, bits: int = BITS, seed: int = 0,
               device: str = "cuda", data: str = "uniform"):
    """(qg (B, heads, r, D) bf16, a KiviLayerCache) made on `device`, a
    window of min(W, T - fill) tokens behind `fill` quantized ones.
    data "uniform": random words, scales and minima uniform in
    [0.01, 0.1), q ~ N(0, 1) (the logits spread ~0.07: a flat softmax);
    "normal": keys, values and windows ~ N(0, 1), the stores quantized by
    `core.quant`, q ~ N(0, Q_STD^2) (logits spread ~Q_STD)."""
    g = torch.Generator(device=device).manual_seed(seed)
    H, nw = heads, min(W, T - fill)
    if data == "uniform":
        def words():
            return torch.randint(-2 ** 31, 2 ** 31 - 1,
                                 (B, H, Q.num_words(D, bits), T),
                                 generator=g, device=device,
                                 dtype=torch.int32)

        def unif(*shape):
            return (torch.rand(shape, generator=g, device=device) * 0.09
                    + 0.01).to(torch.bfloat16)

        k = (words(), unif(B, H, T // GS, D), unif(B, H, T // GS, D))
        v = (words(), unif(B, H, D // GS, T), unif(B, H, D // GS, T))
        win = (unif(B, H, W, D), unif(B, H, W, D))
        std = 1.0
    elif data == "normal":
        def randn(*shape):
            return torch.randn(shape, generator=g, device=device)

        def stored(codes, scale, mn):     # the cache's dtypes and layout
            return (codes.contiguous(),
                    scale.to(torch.bfloat16).contiguous(),
                    mn.to(torch.bfloat16).contiguous())

        k = stored(*Q.quantize_k_block(randn(B, H, D, T), GS, bits))
        v = stored(*Q.quantize_v_block(randn(B, H, T, D), GS, bits))
        win = (randn(B, H, W, D).bfloat16(), randn(B, H, W, D).bfloat16())
        std = Q_STD
    else:
        raise ValueError(f"make_cache: data {data!r} not in {DATA}")
    cache = KiviLayerCache(*k, *v, *win, n_k_quant=fill, n_k_win=nw,
                           n_v_quant=fill, n_v_win=nw)
    qg = (torch.randn((B, H, r, D), generator=g, device=device)
          * std).to(torch.bfloat16)
    return qg, cache


def _stores(c: KiviLayerCache, n: int):
    """The quantized stores' first n positions (views)."""
    return (c.k_codes[..., :n], c.k_scale[:, :, :-(-n // GS)],
            c.k_mn[:, :, :-(-n // GS)], c.v_codes[..., :n],
            c.v_scale[..., :n], c.v_mn[..., :n])


def attention_bound(qg, c: KiviLayerCache, n: int, window: int):
    """(ms, "bytes"/"operations") of attention over n quantized and
    `window` fp positions: each input byte read once, the f32 output
    written once."""
    nbytes = (tensor_bytes((_stores(c, n), c.k_win[:, :, :window],
                            c.v_win[:, :, :window], qg))
              + qg.numel() * 4)
    B, H, r, _ = qg.shape
    return bound(nbytes, 4 * B * H * r * (n + window) * D)


def _bits(c: KiviLayerCache) -> int:
    return 32 * c.k_codes.shape[2] // D


def _trimmed(qg, c: KiviLayerCache, **kw):
    bits = _bits(c)
    return TR.trimmed(qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes,
                      c.v_scale, c.v_mn, c.n_k_quant, group_size=GS,
                      k_bits=bits, v_bits=bits, **kw)


def _wide(qg, c: KiviLayerCache, plain: bool = False, window: bool = True):
    """The wide decode kernel (or its plain version) over the cache, with
    its window or (window=False) an empty one."""
    bits = _bits(c)
    fn = (FD.fused_decode_attention_wide_plain if plain
          else FD.fused_decode_attention_wide)
    nkw = c.n_k_win if window else 0
    return fn(qg, *_stores(c, c.max_seq_len), c.k_win, c.v_win,
              c.n_k_quant, nkw, c.n_v_quant, group_size=GS, k_bits=bits,
              v_bits=bits)


def _route(qg, c: KiviLayerCache):
    """The decode route core.attention picks for the cache (split or
    fused) -> (B, H, r, D)."""
    B, H, r, _ = qg.shape
    return TA.decode_attention(qg.reshape(B, H * r, 1, D), c,
                               qcfg(_bits(c))).reshape(qg.shape)


def check(qg, c: KiviLayerCache, *, rtol: float = RTOL,
          atol: float = ATOL, what: str = "") -> float:
    """Hold the probe's path to its plain versions on one cache (a window
    behind n_k_quant = n_v_quant = fill) and return the largest
    max|kernel - plain|: every trimmed variant against trimmed_plain,
    and bit-equal across two runs; the attention variants (full, fold)
    also against the plain decode at an empty window; the wide kernel and
    the decode route core.attention picks against the plain decode with
    the window.  Each comparison within rtol * max|plain| + atol."""
    B, H, r, _ = qg.shape
    fill, bits = c.n_k_quant, _bits(c)
    geo = f"{what}B={B} Hkv={H} r={r} bits={bits} fill={fill}"
    worst = 0.0

    def held(got, want, name):
        nonlocal worst
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not (torch.isfinite(got).all() and err <= rtol * scale + atol):
            raise AssertionError(f"{name} {geo}: max|kernel - plain| "
                                 f"{err:.3e} > {rtol} * {scale:.3e} + {atol}")
        print(f"[check] {name} {geo}: max|kernel - plain| {err:.3e} "
              f"(max|plain| {scale:.3e})", flush=True)
        worst = max(worst, err)

    decode = _wide(qg, c, plain=True, window=False)
    for key in TR.VARIANTS:
        kw = dict(zip(("scales", "do_qk", "do_vpath", "do_unpack"), key))
        got = _trimmed(qg, c, **kw)
        if not torch.equal(got, _trimmed(qg, c, **kw)):
            raise AssertionError(f"{variant_name(*key)} {geo}: two runs "
                                 "differ")
        held(got, TR.trimmed_plain(
            qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            fill, group_size=GS, k_bits=bits, v_bits=bits, **kw),
            variant_name(*key))
        if key[0] != "none" and all(key[1:]):
            held(got, decode, f"{variant_name(*key)} vs the plain decode, "
                              "empty window,")
    plain = _wide(qg, c, plain=True)
    held(_wide(qg, c), plain, f"wide kernel, window {c.n_k_win},")
    route = "split" if TA.use_split(B * H, fill) else "fused"
    held(_route(qg, c), plain, f"decode route ({route}), window "
                               f"{c.n_k_win},")
    return worst


def profile(B: int, T: int, fill: int, iters: int, smi: str,
            device: str = "cuda") -> list:
    """Time the anchors and every trimmed variant; print one line each.
    Returns [{"item", "ms", "bound_ms", "bound_by"}].  On the CPU (the
    tests) the wrappers take their plain versions and the times are the
    host's."""
    qg, c = make_cache(B, T, fill, device=device)
    mem = memory_snapshot(device)
    alloc = ("not measured" if mem is None else
             f"{mem['allocated_bytes.all.current'] / 1e6:.1f} MB")
    print(f"[config] B={B} Hkv={HKV} r={R} D={D} T={T} fill={fill} KIVI-"
          f"{BITS} group {GS}, window {c.n_k_win}: cache "
          f"{tensor_bytes(c) / 1e6:.1f} MB on {device} (allocated {alloc}),"
          f" {iters} calls a loop | card {smi}", flush=True)
    q4 = qg.reshape(B, HKV * R, 1, D)
    route = "split" if TA.use_split(B * HKV, fill) else "fused"
    items = [
        ("wide kernel (fused_decode_attention_wide)", _wide, qg, c.n_k_win),
        (f"decode route ({route}, core.attention)",
         lambda q, c: TA.decode_attention(q, c, qcfg()), q4, c.n_k_win),
    ]
    for key in TR.VARIANTS:
        kw = dict(zip(("scales", "do_qk", "do_vpath", "do_unpack"), key))
        items.append((variant_name(*key),
                      lambda q, c, kw=kw: _trimmed(q, c, **kw), qg, 0))
    rows = []
    for name, fn, q, window in items:
        ms = bench_fn(fn, q, c, iters=iters) * 1e3
        bms, by = attention_bound(qg, c, fill, window)
        print(f"[time] {name:44s} {ms:9.4f} ms | bound {bms:.4f} ms ({by})"
              f" | {ms / bms:6.1f}x | card {smi}", flush=True)
        rows.append(dict(item=name, ms=ms, bound_ms=bms, bound_by=by))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="5 calls a timing loop instead of 20")
    ap.add_argument("--check", action="store_true",
                    help="hold the kernels to their plain versions on the "
                         "profiler's cache and a peaked one, and exit")
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--T", type=int, default=32768)
    ap.add_argument("--fill", type=int, default=32640)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wide_32k: CUDA is not available")
    if not (0 < args.fill <= args.T and args.T % 128 == 0):
        raise SystemExit("profile_wide_32k: need 0 < fill <= T, T % 128 == 0")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    if args.check:
        for data in DATA:
            check(*make_cache(args.B, args.T, args.fill, data=data),
                  what=f"{data} ")
        return []
    return profile(args.B, args.T, args.fill, 5 if args.quick else 20, smi)


if __name__ == "__main__":
    main()
