"""idle_share.itl (%): the share of the profiled steps in which no kernel or
copy ran on the device."""

from kvbench.readers import idle_share


def read(rec):
    return idle_share(rec)
