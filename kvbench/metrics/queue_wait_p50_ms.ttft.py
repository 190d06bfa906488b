"""queue_wait_p50_ms.ttft (ms): the median, over the requests due in the
window, of the time from each one's due time to the start of the step
that admitted it."""

import statistics


def read(rec):
    w = [r["admit_step"] - r["due"] for r in rec.requests
         if r["admit_step"] is not None]
    return 1e3 * statistics.median(w) if w else None
