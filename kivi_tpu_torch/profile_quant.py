"""Rows 1-2, the quantizers (`kernels/quant_pack.py` over
`csrc/quant_pack.cu`), on one GPU: both entries held to their plain
versions, then timed.

    python3 -m kivi_tpu_torch.profile_quant [--check] [--probe] [--reps N]

`check_into` holds the in-place entry (`quantize_pack_k/v_into`) to its
plain version on whole stores pre-filled with a sentinel (so rows the
predicate leaves out are seen untouched), with two runs bit-equal and a
control (one row's predicate flipped, or the host offset moved by a
group) that must differ, at small edge cases and at the shapes the main
path gives it (`MAIN_PATH_INTO`); `check_fresh` holds the contract entry
(`quantize_pack_k/v`) to its plain version.  chip_smoke.py and
tests/test_torch_kernels_cuda.py run both.

Timings (`utils.timing.cuda_ms`: median device time of single calls, the
host's enqueue held out; bound = bytes / 3.35 TB/s), K and V, KIVI-2,
group 32, D 128:
  * the contract entry at the shapes the main path gives it:
    (8, 32, 128, 128), a decode-step flush or a 128-token chunk;
    (8, 32, 1024, 128), the one-shot ingest; (1, 8, 32, 128) and
    (1, 8, 128, 128), the long slice's flush and chunk;
  * the in-place entry at the batcher's step (8 slots, 32 heads, W 128,
    v_flush 128, Tmax 4096, bf16 stats) with no row, one row and every
    row flushing, beside the sequence a slot cache ran without it: the
    contract entry over every row, then three `masked_store_write`
    (gather, where, scatter) for codes, scale and min.  Both are also
    timed with `hold=False` (the host's enqueue counted, as the
    batcher's host-bound step sees it).
With --probe, the contract entry at those four shapes is also timed
through one build of `csrc/quant_pack.cu` per value of its
`KIVI_QUANT_PROBE` switch (the launch alone, the loads only, no words:
the header of that file says what each does), the kernel's own build
held to the plain version first.
Prints one line per timing with the card's name and power limit, and a
JSON object last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import quant_pack as QP
from kivi_tpu_torch.kernels.quant_pack import masked_store_write
from kivi_tpu_torch.utils.device import card
from kivi_tpu_torch.utils.timing import bound, cuda_ms

SHAPES = ((8, 32, 128, 128), (8, 32, 1024, 128), (1, 8, 32, 128),
          (1, 8, 128, 128))
SLOTS, HEADS, W, TMAX, D, GS, BITS = 8, 32, 128, 4096, 128, 32, 2
SENTINEL_CODE, SENTINEL_STAT = 0x5A5A5A5A, 7.0
NAMES = {True: "quantize_pack_k", False: "quantize_pack_v"}


def _fns(is_key: bool):
    """(contract entry, its plain version, in-place entry, its plain)."""
    if is_key:
        return (QP.quantize_pack_k, QP.quantize_pack_k_plain,
                QP.quantize_pack_k_into, QP.quantize_pack_k_into_plain)
    return (QP.quantize_pack_v, QP.quantize_pack_v_plain,
            QP.quantize_pack_v_into, QP.quantize_pack_v_into_plain)


def _randn(gen, shape, device="cuda"):
    return torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16)


def stores(is_key: bool, B: int, H: int, D: int, tmax: int, bits: int,
           gs: int, sdt, fill: bool = True, device="cuda"):
    """A cache's (codes, scale, mn) stores for one kind, filled with the
    sentinel (fill) or zeros."""
    sshape = (B, H, tmax // gs, D) if is_key else (B, H, D // gs, tmax)
    codes = torch.zeros((B, H, D * bits // 32, tmax), dtype=torch.int32,
                        device=device)
    scale = torch.zeros(sshape, dtype=sdt, device=device)
    mn = torch.zeros(sshape, dtype=sdt, device=device)
    if fill:
        codes.fill_(SENTINEL_CODE)
        scale.fill_(SENTINEL_STAT)
        mn.fill_(SENTINEL_STAT)
    return codes, scale, mn


def check_fresh(is_key: bool, bits: int, gs: int, shape, layout: str,
                seed: int = 0) -> None:
    """The contract entry on a (B, H, T, D) bf16 block against its plain
    version, bit for bit, and two runs bit-equal.  layout: "contiguous";
    "window" (the first T tokens of a longer block: a token-strided
    view); "unaligned" (a base one element past a 16-byte boundary, which
    takes the runtime-shape kernel)."""
    kern, plain, _, _ = _fns(is_key)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    B, H, T, D_ = shape
    if layout == "window":
        x = _randn(gen, (B, H, T + 32, D_))[:, :, :T]
    elif layout == "unaligned":
        n = B * H * T * D_
        x = _randn(gen, (n + 1,))[1:].view(B, H, T, D_)
    else:
        x = _randn(gen, shape)
    x[0, 0, :gs, :gs] = 0.5                 # a constant group: scale 0
    got, again, want = kern(x, gs, bits), kern(x, gs, bits), plain(x, gs,
                                                                   bits)
    torch.cuda.synchronize()
    for g, a, w, what in zip(got, again, want, ("codes", "scale", "mn")):
        # tolerance: none - codes, scale and min bit-equal
        if not (torch.equal(g, w.contiguous()) and torch.equal(g, a)):
            raise AssertionError(
                f"{NAMES[is_key]} bits={bits} gs={gs} {shape} {layout}: "
                f"{what} differ from the plain version or between runs "
                f"({(g != w).sum().item()} elements)")


MODES = ("all", "one", "none", "every", "host")
# The in-place entry at the shapes the main path gives it, bf16 stats:
# (B, H, n, Tmax, modes, the offset of mode "host").  The batcher's
# flush of a decode step (8 slots, W 128, device offsets and predicate);
# the engine's one-shot ingest (8 x 1024 tokens at offset 0); the long
# slice's flush of its 32-token window and a 128-token chunk, near its
# 12,032-token prompt's end in a 16,384-token cache.
MAIN_PATH_INTO = ((8, 32, 128, 4096, ("none", "one", "all"), 0),
                  (8, 32, 1024, 4096, ("host",), 0),
                  (1, 8, 32, 16384, ("host",), 12032),
                  (1, 8, 128, 16384, ("host",), 11904))


def into_case(B: int, n: int, tmax: int, mode: str, gs: int,
              host_off: int = 64):
    """Offsets and predicate of one check: row i at offset (0, 128, Tmax,
    130)[i % 4] + (i // 4) * n (a selected row past Tmax - n clamps
    there; 130 is not a multiple of 4, and the codes go 4 bytes at a
    time).  mode: "all" rows, "one" (row 2, clamped), "none", "every" (no
    predicate), or "host" (one host-int offset, host_off).  Returns (off,
    pred, control off, control pred): the control flips row 0's
    predicate, or moves the host offset by one group."""
    if mode == "host":
        return host_off, None, host_off + gs, None
    off = torch.tensor([(0, 128, tmax, 130)[i % 4] + i // 4 * n
                        for i in range(B)], dtype=torch.int32, device="cuda")
    pred = torch.zeros(B, dtype=torch.bool, device="cuda")
    if mode in ("all", "every"):
        pred[:] = True
    elif mode == "one":
        pred[2] = True
    ctrl = pred.clone()
    ctrl[0] = ~ctrl[0]
    return off, None if mode == "every" else pred, off, ctrl


def check_into(is_key: bool, bits: int, gs: int, n: int, sdt, mode: str,
               D_: int = D, seed: int = 0, B: int = 4, H: int = 8,
               tmax: int | None = None, host_off: int = 64) -> None:
    """The in-place entry against its plain version on whole stores
    filled with the sentinel: bit-equal, two runs bit-equal, and the
    control refused.  The block is a K window (B, H, n, D) or the first n
    tokens of a V window of n + 32 (a token-strided view); the stores
    hold tmax (default max(512, 2n)) positions.  See into_case for the
    offsets each mode selects."""
    _, _, into, into_plain = _fns(is_key)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    full = _randn(gen, (B, H, n + 32, D_))
    x = full[:, :, :n].contiguous() if is_key else full[:, :, :n]
    x[0, 0, :gs, :gs] = 0.5
    tmax = tmax or max(512, 2 * n)
    off, pred, c_off, c_pred = into_case(B, n, tmax, mode, gs, host_off)
    what = (f"{NAMES[is_key]}_into bits={bits} gs={gs} ({B}, {H}, {n}, "
            f"{D_}) Tmax={tmax} {sdt} {mode}")

    def run(fn, o, p):
        st = stores(is_key, B, H, D_, tmax, bits, gs, sdt)
        fn(x, gs, bits, *st, o, p)
        return st

    got, again, want = (run(into, off, pred), run(into, off, pred),
                        run(into_plain, off, pred))
    ctrl = run(into_plain, c_off, c_pred)
    torch.cuda.synchronize()
    for g, a, w, name in zip(got, again, want, ("codes", "scale", "mn")):
        # tolerance: none - every byte of every store
        if not (torch.equal(g, w) and torch.equal(g, a)):
            raise AssertionError(
                f"{what}: {name} store differs from the plain version or "
                f"between runs ({(g != w).sum().item()} elements)")
    if all(torch.equal(g, c) for g, c in zip(got, ctrl)):
        raise AssertionError(f"{what}: the control (row 0 flipped, or the "
                             "offset moved) was not refused")


def check_into_main_path(is_key: bool, bits: int = BITS) -> list:
    """check_into at every shape of MAIN_PATH_INTO with bf16 stats, as
    the main path's caches hold them; returns the cases checked."""
    done = []
    for B, H, n, tmax, modes, host_off in MAIN_PATH_INTO:
        for mode in modes:
            check_into(is_key, bits, GS, n, torch.bfloat16, mode, B=B, H=H,
                       tmax=tmax, host_off=host_off)
            done.append(f"({B}, {H}, {n}, {D}) Tmax {tmax} {mode}")
    return done


def fresh_bytes(B: int, H: int, T: int, D_: int, bits: int = BITS,
                gs: int = GS, stat_bytes: int = 4) -> int:
    """Bytes a quantizer must move: the bf16 block in, the codes and the
    scale and min (f32 unless stat_bytes says otherwise) out."""
    return (B * H * T * D_ * 2 + B * H * (D_ * bits // 32) * T * 4
            + 2 * B * H * T * D_ // gs * stat_bytes)


def batcher_state(is_key: bool, seed: int = 0):
    """The batcher step's quantizer inputs for one kind: the window's
    flush block ((8, 32, 128, 128), for V the first v_flush = 128 tokens
    of the window), bf16-stat stores at Tmax 4096, each row's n_quant (a
    multiple of 128), and the predicates that select no row, one row and
    every row."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    win = _randn(gen, (SLOTS, HEADS, W, D))
    st = stores(is_key, SLOTS, HEADS, D, TMAX, BITS, GS, torch.bfloat16,
                fill=False)
    off = (torch.randint(0, TMAX // W - 1, (SLOTS,), generator=gen,
                         device="cuda") * W).to(torch.int32)
    preds = {k: torch.zeros(SLOTS, dtype=torch.bool, device="cuda")
             for k in ("none", "one", "all")}
    preds["one"][3] = True
    preds["all"][:] = True
    return win[:, :, :W], st, off, preds


def masked_sequence(is_key: bool, x, st, off, pred):
    """What a slot cache's masked flush ran without the in-place entry:
    the contract entry over every row, then one gather/where/scatter
    write per store at each row's offset."""
    kern = _fns(is_key)[0]
    c, s, m = kern(x, GS, BITS)
    masked_store_write(st[0], c, off, 3, pred)
    if is_key:
        masked_store_write(st[1], s, off // GS, 2, pred)
        masked_store_write(st[2], m, off // GS, 2, pred)
    else:
        masked_store_write(st[1], s, off, 3, pred)
        masked_store_write(st[2], m, off, 3, pred)


def time_fresh(is_key: bool, reps: int = 1) -> dict:
    """{key: ms}: the contract entry (fresh_<shape>) at every shape of
    SHAPES with its bound, and the plain version at the first."""
    kern, plain, _, _ = _fns(is_key)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for shape in SHAPES:
        x = _randn(gen, shape)
        tag = "x".join(map(str, shape))
        out[f"fresh_{tag}"] = [cuda_ms(lambda: kern(x, GS, BITS))
                               for _ in range(reps)]
        out[f"fresh_{tag}_bound"] = bound(fresh_bytes(*shape), 0)[0]
        if shape == SHAPES[0]:
            out["plain"] = cuda_ms(lambda: plain(x, GS, BITS))
    return out


def time_into(is_key: bool, reps: int = 1) -> dict:
    """{key: ms}: the in-place entry at the batcher's step with no, one
    and every row flushing (into_<none|one|all>: device time; _host: the
    host's enqueue included), and each one's bound: the selected rows'
    blocks in, their codes and bf16 stats out."""
    into = _fns(is_key)[2]
    x, st, off, preds = batcher_state(is_key)
    out = {}
    for hold, sfx in ((True, ""), (False, "_host")):
        for k, p in preds.items():
            out[f"into_{k}{sfx}"] = [
                cuda_ms(lambda: into(x, GS, BITS, *st, off, p), hold=hold)
                for _ in range(reps)]
    row = fresh_bytes(1, HEADS, W, D, stat_bytes=2)
    for k, p in preds.items():
        out[f"into_{k}_bound"] = bound(row * int(p.sum()), 0)[0]
    return out


def time_sequence(is_key: bool, reps: int = 1) -> dict:
    """{key: ms}: masked_sequence at the batcher's step with one row
    flushing (masked_seq, and masked_seq_host with the enqueue), and its
    bound: every row's block in and codes and stats out."""
    x, st, off, preds = batcher_state(is_key)
    out = {}
    for hold, sfx in ((True, ""), (False, "_host")):
        out[f"masked_seq{sfx}"] = [
            cuda_ms(lambda: masked_sequence(is_key, x, st, off,
                                            preds["one"]), hold=hold)
            for _ in range(reps)]
    out["masked_seq_bound"] = bound(
        SLOTS * fresh_bytes(1, HEADS, W, D, stat_bytes=2), 0)[0]
    return out


def time_kind(is_key: bool, reps: int = 1) -> dict:
    """time_fresh, time_into and time_sequence of one kind, in one dict."""
    return {**time_fresh(is_key, reps), **time_into(is_key, reps),
            **time_sequence(is_key, reps)}


# build name -> extra nvcc flags (csrc/quant_pack.cu's switches)
PROBES = {"kernel": [], "empty": ["-DKIVI_QUANT_PROBE=1"],
          "loads only": ["-DKIVI_QUANT_PROBE=2"],
          "no words": ["-DKIVI_QUANT_PROBE=3"]}


def probe(reps: int, smi: str) -> dict:
    """{build: {kind shape: [ms]}}: the contract entry through each
    probe build, at every shape of SHAPES; the kernel's own build held
    to the plain version first (the others compute less)."""
    libs = _build.build_probes("quant_pack", PROBES)
    for name in PROBES:
        for line in _build.BUILD_LOG.get(f"quant_pack {name}", "").split(
                "\n"):
            if "registers" in line or "spill" in line:
                print(f"[probe] {name}: {line.strip()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    xs = {shape: _randn(gen, shape) for shape in SHAPES}
    out = {}
    for name, lib in libs.items():
        with _build.through("quant_pack", lib):
            t = out[name] = {}
            for is_key in (True, False):
                if name == "kernel":
                    for bits in (2, 4, 8):
                        check_fresh(is_key, bits, GS, SHAPES[1], "window")
                kern = _fns(is_key)[0]
                for shape, x in xs.items():
                    key = f"{NAMES[is_key]} {'x'.join(map(str, shape))}"
                    t[key] = [cuda_ms(lambda: kern(x, GS, BITS))
                              for _ in range(reps)]
                    print(f"[probe] {name}: {key} "
                          + ", ".join(f"{v:.5f}" for v in t[key])
                          + f" ms | card {smi}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="hold both entries to their plain versions "
                    "first, the in-place one also at MAIN_PATH_INTO")
    ap.add_argument("--probe", action="store_true",
                    help="time the kernel's phases through probe builds")
    ap.add_argument("--reps", type=int, default=2,
                    help="timings of each entry at each shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_quant: CUDA is not available")
    smi = card()
    if args.check:
        for is_key in (True, False):
            for bits in (2, 4, 8):
                check_fresh(is_key, bits, GS, (8, 32, 128, D), "window")
                for mode in MODES:
                    check_into(is_key, bits, GS, 128, torch.bfloat16, mode)
            check_into_main_path(is_key)
        print(f"[check] both entries bit-equal to their plain versions, "
              f"controls refused | card {smi}")
    res = {"probe": probe(args.reps, smi)} if args.probe else {}
    for is_key in (True, False):
        name = NAMES[is_key]
        r = res[name] = time_kind(is_key, args.reps)
        for k, v in r.items():
            if not k.endswith("bound"):
                b = r.get(f"{k}_bound")
                print(f"[time] {name} {k}: {v} ms"
                      + (f" | bound {b:.5f} ms" if b is not None else "")
                      + f" | card {smi}")
    print(smi)
    print(json.dumps({"card": smi, "times": res}))
    return res


if __name__ == "__main__":
    main()
