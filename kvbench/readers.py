"""What the metric readers share: percentiles, the window's bounds, and
the readings of the profiled slice.  Each metric's own file in
`metrics/` calls one of these or reads the record itself."""

from __future__ import annotations

import statistics

from kvbench import roofline

# row 6's kernel (`kdec::decode_kernel<..., Ablation<0>, true>`, the
# per-row KIVI decode of `csrc/fused_decode_rows.cu`) by its name
ROW6 = "Ablation<0>, true>"


def percentile(xs: list, q: int) -> float:
    """The q-th percentile, linear between the order statistics
    (`statistics.quantiles`, inclusive)."""
    if len(xs) == 1:
        return float(xs[0])
    return statistics.quantiles(xs, n=100, method="inclusive")[q - 1]


def in_window(rec, t: float) -> bool:
    return rec.t0 <= t < rec.t0 + rec.seconds


def idle_share(rec):
    """% of the profiled slice in which no kernel or copy ran."""
    p = rec.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def mfu(rec):
    """% of the window that the least time of its forwards fills (on the
    card only: a CPU run's time is not the chip's)."""
    if not rec.on_card or not rec.forwards or not rec.window_s > 0:
        return None
    return 100.0 * sum(rec.forwards) / rec.window_s


def decode_roofline(rec, fragment: str = ROW6):
    """% of the decode kernel's device time in the profiled slice that
    the least time of its calls fills (one call a step in each of the
    family's `decode_layers`)."""
    p = rec.profile
    if p is None:
        return None
    t = p.kernel_s(fragment)
    steps = p.counters.get("decode_rows", [])
    if t <= 0 or not steps:
        return None
    fam = rec.family.roofline
    bound = sum(roofline.bound_s(*fam.decode_attention(
        rec.cfg, rec.qcfg, rows, shared)) for rows, shared in steps if rows)
    return 100.0 * fam.decode_layers(rec.cfg) * bound / t
