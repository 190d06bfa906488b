"""prompt_share.gen (%): of the time of the window's jobs, the share
before their first decode step (the document's prefill, the fan-out, the
questions' extend, the first token): host spans `job` and
`engine.decode`, the latter entered after a synchronization."""


def read(rec):
    jobs = [s for s in rec.spans.named("job")
            if rec.t0 <= s.start < rec.t0 + rec.window_s]
    dec = rec.spans.named("engine.decode")
    prompt = total = 0.0
    for j in jobs:
        d = [s for s in dec if j.start <= s.start <= j.end]
        if not d:
            return None
        prompt += d[0].start - j.start
        total += j.end - j.start
    return 100.0 * prompt / total if total > 0 else None
