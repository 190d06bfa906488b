"""Run one cell of the benchmark once and print its result line.

    python3 kvbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything comes from `BENCHMARK.json` by name: the cell's configuration
file (`configs/<config>.json`: the port's ModelConfig and QuantConfig
fields, and the family of its block), that family
(`families/<family>.py`: the config objects, the weights, the plain
reference and the roofline counts of the block), its traffic file
(`traffic/<traffic>.json`: the driver, one of `drivers/<driver>.py`, and
its parameters) and one reader per metric (`metrics/<metric>.py`,
`read(record)` -> a number, or None where it finds nothing to read).  A
new cell, traffic mix, metric or block is a new file and a new entry;
nothing here changes.

A run: weights from the seed (the family's), the driver's set-up (the
program built, the cell's shapes warmed), the measured window, then the
check: the program is freed, and the family's plain reference
recomputes a sample of what the window served, drawn from the seed, and
each number of `reference_check` is held to its limit in the traffic
file's `check.limits`.  With
--trace 0 the result carries the cell's end-to-end metrics, with --trace
1 its per-layer metrics (host spans over the window, one profiled
slice).  The last line of standard output is the result, the last lines
of standard error the numbers compared, each beside its limit.

It exits 1 without a CUDA device, and 2 when a JAX module or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script, this file's folder heads sys.path: the checkout's root
# takes its place, so that no file here shadows a module of the same name
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "kivi_tpu"}
NO_ANSWER = 1e30          # a number the window served nothing to read


def _env(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout; one
    host thread for the few CPU tensor ops, so that the thread that
    launches the card's work does not share the cores with a pool."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    cache = os.path.join(root, ".kvbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, os.path.join(cache, sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


@dataclasses.dataclass
class Cell:
    name: str
    cfg: object
    qcfg: object
    family: object       # the configuration's families/<family>.py
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    spans: object


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: str, workload: str, seed: int, seconds: float,
              trace: bool, device) -> tuple:
    """(bench, its workload entry, Cell) for a cell named in root's
    BENCHMARK.json."""
    from kvbench import families
    from kvbench.trace import Spans
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, cf["file"])) as f:
        config = json.load(f)
    family = families.load(root, config, cf["file"])
    cfg, qcfg = family.config(config)
    with open(os.path.join(root, "kvbench", "traffic",
                           wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    cell = Cell(name=workload, cfg=cfg, qcfg=qcfg, family=family,
                traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                device=device, spans=Spans())
    return bench, wl, cell


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in
                                 moved else [])]


def read_metrics(root: str, entries: list, rec) -> dict:
    out = {}
    for m in entries:
        mod = _load(os.path.join(root, "kvbench", "metrics",
                                 m["name"] + ".py"), "kvbench_metric")
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float = T_START) -> tuple:
    """One run: (result dict, the driver's state freed).  device: "cuda"
    on the card; the tests pass "cpu" with a configuration of their
    own."""
    import torch
    from kvbench.record import Record
    from kvbench.trace import breakdown

    bench, wl, cell = load_cell(root, workload, seed, seconds, trace,
                                torch.device(device))
    drv = _load(os.path.join(root, "kvbench", "drivers",
                             cell.traffic["driver"] + ".py"),
                "kvbench_driver")
    cuda = cell.device.type == "cuda"
    fam = cell.family
    params = fam.make_params(cell.cfg, seed, cell.device)
    st = drv.setup(cell, fam.program_params(params))
    rec = Record(cfg=cell.cfg, qcfg=cell.qcfg, traffic=cell.traffic,
                 seconds=seconds, spans=cell.spans, on_card=cuda,
                 family=fam)
    # what set-up made is never garbage: keep the collector off it
    gc.collect()
    gc.freeze()
    drv.window(st, cell, rec)
    rec.setup_s = rec.t0 - t_start
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    items = drv.check_items(st, cell, rec)
    drv.release(st)
    del st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check = judge(reference_check(fam.reference, params, cell, items),
                  cell.traffic["check"]["limits"])
    correct = (bool(items) and rec.failed == 0
               and all(c["value"] <= c["limit"] for c in check.values()))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(cell.device) if cuda
           else "cpu", "count": int(wl["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": rec.failed,
              "metrics": read_metrics(root, metrics_for(bench, workload,
                                                        trace), rec),
              "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile.busy_s
        dev["window_s"] = rec.profile.window_s
        result["breakdown"] = breakdown(rec.profile)
    result["check"] = dict(check, failed={"value": rec.failed, "limit": 0})
    return result, rec


def reference_check(ref, params, cell, items, control: bool = False):
    """The numbers the check compares, over the sampled answers, by the
    reference `ref` (the cell's family's), each item (Group, first,
    tokens, kind) of a driver's `check_items`:

      gap       (kind None: greedy tokens) the widest gap by which a
                served token's reference logit lies below the
                reference's best;
      mean_gap  that gap's mean over every compared position;
      window_layers  (kind ("state", program's windows)) the layers
                whose cache counts after the last decode step differ from
                the cache policy's (`ref.window_gap`): an exact
                comparison;
      window_kv the widest relative gap between the keys and values the
                program's decode steps left in the other layers' windows
                and the reference's.

    A number with nothing to compare is absent.  control: also the
    control's numbers, of what a reference on fp8 operands
    (`ref.logits(low=True)`) chooses: its first token at each
    position, its own keys and values for the windows; returns
    (numbers, control's) then."""
    if not items:
        return ({}, {}) if control else {}
    groups = [it[0] for it in items]
    states = [i for i, it in enumerate(items)
              if it[3] is not None and it[3][0] == "state"]
    logits, kv = ref.logits(params, cell.cfg, cell.qcfg, groups,
                            kv_of=states)
    low, lkv = (ref.logits(params, cell.cfg, cell.qcfg, groups, low=True,
                           kv_of=states) if control
                else ([None] * len(groups), {}))
    got, ctl = _Numbers(), _Numbers()
    for i, (lg, lo, (g, first, toks, kind)) in enumerate(
            zip(logits, low, items)):
        if kind is not None and kind[0] == "state":
            got.window(*ref.window_gap(g, kv[i], kind[1]))
            if control:
                ctl.window(*ref.window_gap(g, kv[i], _as_program(lkv[i])))
            continue
        n = toks.shape[1]
        sel = lg[:, first:first + n].reshape(-1, lg.shape[-1])
        got.gaps.append(ref.gaps(sel, toks.reshape(-1)))
        if lo is not None:
            pick = lo[:, first:first + n].reshape(-1, lo.shape[-1]).argmax(1)
            ctl.gaps.append(ref.gaps(sel, pick))
    return (got.numbers(), ctl.numbers()) if control else got.numbers()


def _as_program(ref_kv: tuple) -> dict:
    """The control's keys and values as a program's windows would hold
    them: every continuation token (the counts are the reference's)."""
    return {"k": ref_kv[0], "v": ref_kv[1]}


class _Numbers:
    def __init__(self):
        self.gaps, self.win = [], None

    def window(self, layers: int, gap: float) -> None:
        was = self.win or (0, 0.0)
        self.win = (was[0] + layers, max(was[1], gap))

    def numbers(self) -> dict:
        import torch
        out = {}
        if self.gaps:
            g = torch.cat(self.gaps)
            out.update(gap=float(g.max()), mean_gap=float(g.mean()))
        if self.win is not None:
            out.update(window_layers=self.win[0], window_kv=self.win[1])
        return out


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number with a limit; a number
    the run could not read counts as NO_ANSWER."""
    return {k: {"value": numbers.get(k, NO_ANSWER), "limit": lim}
            for k, lim in limits.items()}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env(ROOT)
    import torch
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = next(w["chips"] for w in json.load(f)["workloads"]
                     if w["name"] == args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"kvbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 1
    result, rec = run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"kvbench: modules loaded that the benchmark must not load: "
              f"{bad}", file=sys.stderr)
        return 2
    for s in summarize_spans(rec):
        print(s)
    if rec.profile is not None:
        print(f"[kvbench] trace: first and last device event inside the "
              f"slice by {rec.profile.counters.get('trace_edges_us')} us",
              file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def summarize_spans(rec) -> list:
    by = {}
    for s in rec.spans.spans:
        n, t = by.get(s.name, (0, 0.0))
        by[s.name] = (n + 1, t + s.end - s.start)
    return [f"[kvbench] span {k}: {n} x, {t:.6f} s"
            for k, (n, t) in sorted(by.items())]


if __name__ == "__main__":
    sys.exit(main())
