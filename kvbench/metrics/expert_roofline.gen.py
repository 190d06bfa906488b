"""expert_roofline.gen (%): the grouped expert GEMM's share of its
roofline over the profiled job: the least time of every call (the
family's `expert_gemm` of the tokens the program logged on each held
expert, one call an expert layer of each forward) over the device time
of the kernels whose names hold `moe_grouped` (row 13, both launches).
Nothing to read where the family counts no expert GEMM or the driver
logged no call."""

from kvbench import roofline

FRAGMENT = "moe_grouped"


def read(rec):
    p = rec.profile
    gemm = getattr(rec.family.roofline, "expert_gemm", None)
    if p is None or gemm is None:
        return None
    calls = p.counters.get("expert_calls")
    t = p.kernel_s(FRAGMENT)
    if not calls or t <= 0:
        return None
    bound = sum(roofline.bound_s(*gemm(rec.cfg, c)) for c in calls)
    return 100.0 * bound / t
