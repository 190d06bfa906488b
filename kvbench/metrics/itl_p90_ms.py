"""itl_p90_ms (ms): the 90th percentile of every gap between consecutive
tokens of every request due in the window.  The gaps fall in modes: a
replayed decode step alone (about 35 ms), a step that also admits one
request (70-120 ms), one that admits two (140-180 ms).  The 90th
percentile lies inside the one-admission mode; the 95th lies at its
edge with the next and read 114 or 138 ms from run to run of one seed
on the card."""

from kvbench.readers import percentile


def read(rec):
    gaps = [b - a for r in rec.requests
            for a, b in zip(r["times"], r["times"][1:])]
    return 1e3 * percentile(gaps, 90) if gaps else None
