"""gen_tok_s (tokens/s): the generated tokens of every job started in the
window, over the time from the window's start to the end of the last of
them."""


def read(rec):
    if not rec.jobs:
        return None
    return sum(j["tokens"] for j in rec.jobs) / rec.window_s
