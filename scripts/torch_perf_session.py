"""Time the parent tree and this one in one session on one card.

    python3 scripts/torch_perf_session.py --parent DIR --out DIR
        [--paths chunked,oneshot,fp16,batcher,long]
        [-- extra arguments of profile_main_path]

DIR is an unpacked copy of the parent commit (`git archive`).  Timings
on the card drift between sessions and host time drifts within one, so
the two trees are compared in turns: parent, change, change, parent.
In each turn every path runs `python3 -m
kivi_tpu_torch.profile_main_path --path P` from that tree's root (each
tree builds its own kernels on its first run).  Every run's output is
kept in OUT/<turn>-<tree>-<path>.log, and one line per run gives its
exit code and the lines that hold the decode and prefill walls, busy
times and idle shares.  Exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEEP = re.compile(r"^\[(card|config)\]|^\[(prefill|decode)\] host wall"
                  r"|^\[decode\] [\d.]+ tokens/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--paths", default="chunked,oneshot,fp16,batcher,long")
    ap.add_argument("--out", required=True, type=Path,
                    help="directory for the runs' logs")
    ap.add_argument("extra", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    extra = [a for a in args.extra if a != "--"]
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    failed = 0
    for turn, tree in enumerate(("parent", "change", "change", "parent")):
        for path in args.paths.split(","):
            cmd = [sys.executable, "-m", "kivi_tpu_torch.profile_main_path",
                   "--path", path, *extra]
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=trees[tree], text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT,
                                 env={**os.environ, "PYTHONPATH": ""})
            log = args.out / f"{turn}-{tree}-{path}.log"
            log.write_text(run.stdout)
            failed += run.returncode != 0
            print(f"[session] turn {turn} {tree} {path}: exit "
                  f"{run.returncode} in {time.perf_counter() - t0:.1f} s "
                  f"({log.name})", flush=True)
            for line in run.stdout.splitlines():
                if KEEP.search(line):
                    print(f"[session]   {line}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
