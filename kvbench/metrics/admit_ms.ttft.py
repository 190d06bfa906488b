"""admit_ms.ttft (ms): the mean, over the requests due in the window, of
the time an admitting step spent on each one: from the step's start, or
the previous admission's first token in it, to the request's first
token."""

import statistics


def read(rec):
    a = [r["admit_s"] for r in rec.requests if r["admit_s"] is not None]
    return 1e3 * statistics.fmean(a) if a else None
