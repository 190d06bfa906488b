"""The profile reduction on a trace made by hand: busy time as the union
of device intervals inside the profiled slice, kernels summed by name,
idle gaps labelled by the innermost harness span open where they
start."""

from kvbench import trace


def test_reduce_profile_by_hand():
    dev = [("gemm", 10, 20), ("gemm", 15, 25), ("row6", 40, 45),
           ("row6", 70, 80), ("late", 95, 130), ("early", -20, -5)]
    marks = [("step", 0, 60), ("admit", 30, 50)]
    p = trace.reduce_profile(dev, 0, 100, marks, {"n": 1})
    assert p.window_s == 100e-6
    assert abs(p.busy_s - 35e-6) < 1e-12          # 15 + 5 + 10 + 5
    assert abs(p.kernels["gemm"] - 20e-6) < 1e-12
    assert abs(p.kernels["late"] - 5e-6) < 1e-12  # clipped to the slice
    assert "early" not in p.kernels               # before the slice
    # gaps 0-10 and 25-40 under `step`, 45-70 under `admit` (the
    # innermost), 80-95 under none; longest first
    assert p.gaps[0][0] == "admit" and abs(p.gaps[0][1] - 25e-6) < 1e-12
    by = sorted((round(t * 1e6), n) for n, t in p.gaps)
    assert by == [(10, "step"), (15, "no span"), (15, "step"), (25, "admit")]
    b = trace.breakdown(p)
    assert b["device_ops"][0][0] == "gemm" and len(b["idle_gaps"]) == 4


def test_host_clock_meets_the_trace_clock():
    """Host spans go onto the profiler's clock by the offset between
    time.time_ns and time.perf_counter: a CPU operator's event, stamped
    by the profiler, lands inside the span around it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = trace._clock_offset_us()
        a = time.perf_counter()
        with record_function("kvb.probe"):
            torch.ones(64).sum()
        b = time.perf_counter()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "kvb.probe"][0]
    s, e = ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3
    assert a * 1e6 + off - 50 <= s <= e <= b * 1e6 + off + 50
