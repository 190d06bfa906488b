"""attn_decode_roofline.gen (%): row 6's share of its roofline over the
profiled job: the least time of its calls (the family's decode_attention
of the counts each decode step reads, the shared document once) over its
device time."""

from kvbench.readers import decode_roofline


def read(rec):
    return decode_roofline(rec)
