"""attn_decode_roofline.itl (%): row 6's share of its roofline over the
profiled steps: the least time of its calls (the family's
decode_attention of the active slots' real tokens, pads not counted)
over its device time."""

from kvbench.readers import decode_roofline


def read(rec):
    return decode_roofline(rec)
