"""Measurements that set the benchmark's numbers, run once on the card;
the benchmark's own runs never run them.

    python3 kvbench/tools.py readings --workload W --seeds S.. \\
        [--control-seeds C..] [--fault F] --seconds N
        For each seed, one window of the cell (weights refilled in place
        from the seed, the program built once), then the numbers of the
        check (run.reference_check); on the
        control seeds also the control's, of the tokens an fp8 reference
        (the family's reference, low=True) chooses.  --fault plants one of
        faults.FAULTS under the program before it is built.  These set
        `check.limits`.

    python3 kvbench/tools.py sweep --workload W --rates R.. --seconds N
        A `batcher_open` cell's window at each offered rate, one after the
        other in one process: requests due, finished, the queue (due, not
        yet admitted) at the window's start and end, the tails, tokens a
        second, the slots in use a step (mean, 99th percentile, most) and
        the KIVI cache those slots hold (the prompts' and the served
        tokens; the pads to a prompt bucket besides).  The highest rate
        whose queue does not grow is the knee.

One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT

from kvbench.faults import FAULTS  # noqa: E402


def _program(workload: str, seed: int, seconds: float):
    import torch
    from kvbench import run
    bench, wl, cell = run.load_cell(ROOT, workload, seed, seconds, False,
                                    torch.device("cuda"))
    drv = run._load(os.path.join(ROOT, "kvbench", "drivers",
                                 cell.traffic["driver"] + ".py"),
                    "kvbench_driver")
    params = cell.family.make_params(cell.cfg, seed, cell.device)
    st = drv.setup(cell, cell.family.program_params(params))
    return bench, cell, drv, params, st


def _window(cell, drv, st):
    from kvbench.record import Record
    from kvbench.trace import Spans
    cell.spans = Spans()
    rec = Record(cfg=cell.cfg, qcfg=cell.qcfg, traffic=cell.traffic,
                 seconds=cell.seconds, spans=cell.spans, family=cell.family)
    if hasattr(st, "outputs"):
        st.outputs = {}
    gc.collect()
    gc.freeze()
    drv.window(st, cell, rec)
    return rec


def readings(args) -> None:
    from kvbench import faults, run
    if args.fault:
        faults.plant(args.fault)
    bench, cell, drv, params, st = _program(args.workload, args.seeds[0],
                                            args.seconds)
    for i, seed in enumerate(args.seeds):
        cell.seed = seed
        if i:
            cell.family.refill(params, cell.cfg, seed)
        t = time.perf_counter()
        rec = _window(cell, drv, st)
        items = drv.check_items(st, cell, rec)
        ctl = seed in args.control_seeds
        got = run.reference_check(cell.family.reference, params, cell,
                                  items, control=ctl)
        got, cgot = got if ctl else (got, None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "numbers": got,
                          "control": cgot, "attempted": rec.attempted,
                          "failed": rec.failed, "answers": len(items),
                          "seconds": time.perf_counter() - t}), flush=True)


def sweep(args) -> None:
    from kvbench import readers
    bench, cell, drv, params, st = _program(args.workload, args.seed,
                                            args.seconds)
    for rate in args.rates:
        cell.traffic = dict(cell.traffic, rate=rate, drain_s=args.drain)
        rec = _window(cell, drv, st)
        t1 = rec.t0 + rec.seconds

        def queued(t):
            return sum(r["due"] <= t and (not r["times"]
                                          or r["admit_step"] > t)
                       for r in rec.requests)

        done = [r for r in rec.requests if len(r["times"]) == r["max_new"]]
        ttft = [r["times"][0] - r["due"] for r in done]
        gaps = [b - a for r in done for a, b in zip(r["times"],
                                                    r["times"][1:])]
        slots, live, held = occupancy(cell, rec) or ([0], [0], [0])
        print(json.dumps({
            "rate": rate, "due": len(rec.requests), "finished": len(done),
            "slots_mean": statistics.fmean(slots),
            "slots_p99": readers.percentile(slots, 99),
            "slots_max": max(slots),
            "live_cache_gb_mean": statistics.fmean(live) / 1e9,
            "live_cache_gb_max": max(live) / 1e9,
            "held_cache_gb_max": max(held) / 1e9,
            "queue_start": queued(rec.t0 + 1.0), "queue_end": queued(t1),
            "ttft_p50_ms": 1e3 * readers.percentile(ttft, 50) if ttft
            else None,
            "ttft_p90_ms": 1e3 * readers.percentile(ttft, 90) if ttft
            else None,
            "ttft_p95_ms": 1e3 * readers.percentile(ttft, 95) if ttft
            else None,
            "itl_p90_ms": 1e3 * readers.percentile(gaps, 90) if gaps
            else None,
            "tok_s": sum(readers.in_window(rec, x) for x in rec.token_times)
            / rec.seconds}), flush=True)


def occupancy(cell, rec) -> tuple:
    """Per step of the window: the slots it decoded (those it admitted
    among them), the bytes of the KIVI cache their tokens fill (every
    layer that decodes over one, every KV head), and the same with each
    prompt's pads to its bucket; None where no step started in the
    window."""
    from kvbench import roofline
    from kvbench.drivers.batcher_open import bucket
    q, b = cell.qcfg, cell.traffic["batcher"]
    buckets = tuple(b["prompt_buckets"]) + (b["max_seq_len"],)
    W, vf = q.residual_length, q.value_flush
    L = cell.family.roofline.decode_layers(cell.cfg)
    counts = cell.family.reference.decode_counts

    def nbytes(prompt, k):
        return L * roofline.kivi_bytes(cell.cfg, q, *counts(prompt, k, W,
                                                            vf))

    slots, live, held = [], [], []
    for s in rec.steps:
        if not rec.t0 <= s["start"] < rec.t0 + rec.seconds:
            continue
        rows = s["rows"]
        slots.append(len(rows))
        live.append(sum(nbytes(p, k) for p, k in rows))
        held.append(sum(nbytes(bucket(p, buckets), k) for p, k in rows))
    return (slots, live, held) if slots else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", type=int, nargs="+", required=True)
    r.add_argument("--control-seeds", type=int, nargs="*", default=[])
    r.add_argument("--fault", choices=FAULTS, default=None)
    r.add_argument("--seconds", type=float, required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--rates", type=float, nargs="+", required=True)
    s.add_argument("--seconds", type=float, required=True)
    s.add_argument("--drain", type=float, default=20.0)
    args = ap.parse_args(argv)
    from kvbench import run
    run._env(ROOT)
    (readings if args.what == "readings" else sweep)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
