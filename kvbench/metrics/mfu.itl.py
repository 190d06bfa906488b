"""mfu.itl (%): the least time of every forward of the steps that started
in the window (the family's roofline.forward: each admission's prefill
of its real tokens, each batched decode step), over the window."""

from kvbench.readers import mfu


def read(rec):
    return mfu(rec)
