"""serve_tok_s (tokens/s): the tokens emitted in the window, over the
window."""

from kvbench.readers import in_window


def read(rec):
    if not rec.requests:
        return None
    return sum(in_window(rec, t) for t in rec.token_times) / rec.seconds
