"""Device-honest benchmarking: port of `kivi_tpu/utils/timing.py`, plus
the kernel timer and the roofline bound of `chip_smoke.py`.

`bench_loop` / `bench_fn` keep the JAX contract: seconds per call of a
step run in a loop whose every iteration consumes the previous one's
output (a data dependence, so no call can be skipped or overlapped with
a later one's inputs), measured at two loop lengths, each the minimum of
`repeats` runs, and differenced.  The difference cancels what every run
pays once (on CUDA: the launch of the first step and the final
synchronisation); the minimum drops runs slowed by a neighbour on the
host or the card.  On CUDA the runs are timed by CUDA events, on the CPU
(the tests) by `time.perf_counter`.

`cuda_ms` is the kernel timer of `chip_smoke.py`'s table: the median of
single calls by CUDA events, each finding the L2 cache holding other
data, with the host's enqueue kept out of the device time.  `bound` is
the least time the H100 could take for some work.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate


def leaves(tree) -> list:
    """The leaves of nested tuples, lists, dicts and dataclasses."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in leaves(t)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in leaves(getattr(tree, f.name))]
    return [tree]


def bench_loop(step: Callable, init_state, iters: int = 50,
               warmup_iters: int = 5, repeats: int = 3) -> float:
    """Return seconds per iteration of `step` (state -> state).

    Every iteration must consume the previous state, and `step` must not
    modify its input in place: each run starts again from `init_state`.
    The runs of warmup_iters and warmup_iters + iters steps are each
    measured `repeats` times and the minima differenced."""
    tensors = [x for x in leaves(init_state) if isinstance(x, torch.Tensor)]
    if not tensors:
        raise ValueError("bench_loop: the state holds no tensor")
    cuda = tensors[0].is_cuda

    def run(n: int) -> float:
        state = init_state
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                state = step(state)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        return time.perf_counter() - t0

    run(warmup_iters)                       # first calls: builds, caches
    t_w = min(run(warmup_iters) for _ in range(repeats))
    t_n = min(run(warmup_iters + iters) for _ in range(repeats))
    return max(t_n - t_w, 1e-9) / iters


def bench_fn(fn: Callable, *args, iters: int = 50, repeats: int = 3) -> float:
    """Seconds per call of fn(*args) -> tensor(s), feeding a scalar
    derived from the output back into the first argument so that each
    call depends on the one before."""

    def step(state):
        first, rest = state
        out = fn(first, *rest)
        # a non-zero multiplier: the feedback is a real dependence
        leaf = next(x for x in leaves(out) if isinstance(x, torch.Tensor))
        feedback = leaf.float().sum() * 1e-30
        return (first + feedback.to(first.dtype), rest)

    return bench_loop(step, (args[0], tuple(args[1:])), iters=iters,
                      repeats=repeats)


HOLD_CYCLES = 1_000_000   # ~0.5 ms of the SM clock: the host's head start


def cuda_ms(fn: Callable, iters: int = 20, warmup: int = 3,
            hold: bool = True) -> float:
    """Median milliseconds of fn() by CUDA events.  Each timed call finds
    the 50 MB L2 holding other, clean data, as on the main path, where a
    layer's weights pass through L2 between two calls of the same kernel
    (reading the scrub buffer, not writing it, leaves no dirty lines to
    write back during the timed call).  With `hold`, the device is then
    held busy for HOLD_CYCLES (torch.cuda._sleep) before the start event,
    so that fn's launches are enqueued before the device reaches it: the
    time between the events is the device's, not the host's enqueue (a
    wrapper's checks and its ctypes call take tens of microseconds, as
    long as a small kernel).  Without it, a call whose host enqueue
    outlasts its device work (a route of many small launches) is timed at
    its enqueue, as a host-bound caller sees it."""
    scrub = torch.ones(64 << 20, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        scrub.amax()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    """Least time (ms) for the work on an H100 SXM: bytes over the memory
    rate vs operations over the bf16 tensor-core rate, and which one
    bounds it ("bytes" or "operations")."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")
