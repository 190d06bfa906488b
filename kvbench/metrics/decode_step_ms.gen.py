"""decode_step_ms.gen (ms): the window's `engine.decode` spans over the
decode steps they ran."""


def read(rec):
    dec = [s for s in rec.spans.named("engine.decode")
           if rec.t0 <= s.start < rec.t0 + rec.window_s]
    steps = sum(s.meta["steps"] for s in dec)
    return 1e3 * sum(s.end - s.start for s in dec) / steps if steps else None
