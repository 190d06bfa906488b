"""The harness's host spans, and the reduction of a `torch.profiler` trace
to the device's busy time, its kernels and its idle gaps.

Spans are recorded by the benchmark around its calls into the program
(`Spans.span`), on the host's clock, and kept in memory.  A profiled
slice records CUDA activity alone (kernels, copies, sets, through CUPTI):
no host operator is recorded, so the profiler adds little to the host's
time between launches.  The spans are put on the trace's clock by the
offset between `time.time_ns` (the clock kineto stamps its events with)
and `time.perf_counter`, read at both ends of the slice.

`reduce_profile` keeps the device events that overlap the slice: busy is
the union of their intervals inside it (the arithmetic of
`kivi_tpu_torch/profile_main_path.busy_span_us`), the window is the
slice's length, device time is summed by kernel name, and each idle gap
(between busy intervals, or at either end of the slice) is labelled with
the innermost harness span open where it starts.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

PROFILED = "profiled"


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    meta: dict


class Spans:
    """Harness spans on `time.perf_counter`, kept in memory."""

    def __init__(self):
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        s = Span(name, time.perf_counter(), float("nan"), meta)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self.spans.append(s)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


@dataclasses.dataclass
class Profile:
    busy_s: float
    window_s: float
    kernels: dict          # kernel name -> device seconds in the slice
    gaps: list             # [(label, seconds)], longest first
    counters: dict         # what the driver counted inside the slice

    def kernel_s(self, fragment: str) -> float:
        return sum(t for n, t in self.kernels.items() if fragment in n)


def device_events(prof) -> list:
    """(name, start_us, end_us) of every device event of the trace, on
    the trace's clock."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def reduce_profile(dev_events: list, lo: float, hi: float, marks: list,
                   counters: dict) -> Profile:
    """dev_events [(name, start, end)], the slice [lo, hi) and the host
    spans marks [(name, start, end)], all in microseconds on one clock."""
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev_events
           if e > lo and s < hi]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in "
                           "the slice")
    kernels = collections.Counter()
    for n, s, e in dev:
        kernels[n] += (e - s) / 1e6
    iv = sorted((s, e) for _, s, e in dev)
    busy, gaps, cur_s, cur_e = 0.0, [], iv[0][0], iv[0][1]
    if cur_s > lo:
        gaps.append((lo, cur_s))
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < hi:
        gaps.append((cur_e, hi))

    def label(t):
        open_ = [(e - s, n) for n, s, e in marks if s <= t < e]
        return min(open_)[1] if open_ else "no span"

    gaps.sort(key=lambda g: g[0] - g[1])
    return Profile(busy_s=busy / 1e6, window_s=(hi - lo) / 1e6,
                   kernels=dict(kernels),
                   gaps=[(label(s), (e - s) / 1e6) for s, e in gaps[:10]],
                   counters=counters)


def _clock_offset_us() -> float:
    """time.time_ns - time.perf_counter, in microseconds."""
    a = time.perf_counter_ns()
    w = time.time_ns()
    b = time.perf_counter_ns()
    return (w - (a + b) / 2) / 1e3


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiled(spans: Spans, device, counters: dict):
    """Profile the block (CUDA activity); yields a list that holds the
    block's `Profile` once it has ended.  The block is the slice: its
    device work is synchronized at both ends.  On the CPU nothing is
    profiled and the list stays empty: there is no device to read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out: list = []
    if torch.device(device).type != "cuda":
        yield out
        return
    torch.cuda.synchronize(device)
    first = len(spans.spans)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        off0 = _clock_offset_us()
        lo = time.perf_counter()
        yield out
        torch.cuda.synchronize(device)
        hi = time.perf_counter()
        off1 = _clock_offset_us()
    off = (off0 + off1) / 2
    lo, hi = lo * 1e6 + off, hi * 1e6 + off
    marks = [(s.name, s.start * 1e6 + off, s.end * 1e6 + off)
             for s in spans.spans[first:]]
    dev = device_events(prof)
    if dev:
        # how far the first and the last device event lie inside the
        # slice: a few microseconds to milliseconds when the clocks agree
        counters["trace_edges_us"] = (min(s for _, s, _ in dev) - lo,
                                      hi - max(e for _, _, e in dev))
    out.append(reduce_profile(dev, lo, hi, marks, counters))


def breakdown(p: Profile) -> dict:
    top = sorted(p.kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in p.gaps]}
