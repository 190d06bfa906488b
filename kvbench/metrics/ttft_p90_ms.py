"""ttft_p90_ms (ms): the 90th percentile, over the requests due in the
window, of the time from each one's due time to its first token.  A
request never answered counts with the time to the run's last token.
Of 224 requests the 95th percentile rests on the 11 slowest and moved
10-23% between runs of one seed on the card; the 90th rests on 22."""

from kvbench.readers import percentile


def read(rec):
    if not rec.requests:
        return None
    last = max(rec.token_times)
    return 1e3 * percentile([(r["times"][0] if r["times"] else last)
                             - r["due"] for r in rec.requests], 90)
