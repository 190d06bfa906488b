"""decode_step_ms.itl (ms): the median wall time of the window's steps
that admitted nothing and decoded (a replayed decode step and its one
read of the tokens)."""

import statistics

from kvbench.readers import in_window


def read(rec):
    d = [s["end"] - s["start"] for s in rec.steps
         if in_window(rec, s["start"]) and not s["admitted"] and s["rows"]]
    return 1e3 * statistics.median(d) if d else None
