"""mfu.gen (%): the least time of every forward of the window's jobs (the
family's roofline.forward: prefill, extend, decode steps), over the
window's time."""

from kvbench.readers import mfu


def read(rec):
    return mfu(rec)
