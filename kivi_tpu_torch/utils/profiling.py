"""Tracing and memory accounting.

  * the tracer (below): `span(name, device=False, **attrs)` around a
    block, `record(name, start_ns, end_ns, **attrs)`, `enable()`,
    `disable()` and `drain()`;
  * `tensor_bytes(tree)`: bytes of the tensors of a parameter or cache
    structure (the JAX package's `pytree_bytes`);
  * `memory_snapshot()`: the CUDA caching allocator's byte counters, or
    None where there is no CUDA device;
  * `kv_cache_report(...)`: bytes of the KIVI cache against the fp16
    cache, from the shapes `models.modeling.init_caches` allocates.

The tracer keeps spans in memory, on `time.perf_counter_ns`, and is off
by default.  Off, `span` returns one shared no-op context manager: one
flag test, nothing allocated, no event, no sync.  On, a span records its
name, its start and end, its parent (the innermost span open in its
thread when it began) and its attributes, which the block may also set
(`s.attrs["admitted"] = n`).  A span with `device=` also records a CUDA
event on that device's current stream at each end; `drain()` reads the
device time between them (None on the CPU), synchronizing only when such
a span is pending.  The serving path opens spans around its steps,
admissions, prefills, decodes and host reads, and counts ride on them as
attributes.

A span is host code: it never sits inside a body a CUDA graph captures
(utils/graphs.py), where it would run once at capture and never on
replay; with the tracer on, a span opened during a capture raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from kivi_tpu_torch.utils.timing import leaves


class _Sink(dict):
    """The attributes of the off tracer's span: writes are dropped."""

    def __setitem__(self, key, value):
        pass


class _Off:
    """The one span an off tracer hands out: records nothing."""

    __slots__ = ()
    attrs = _Sink()
    start_ns = end_ns = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class Span:
    """A recorded span: `name`, `start_ns` and `end_ns`
    (time.perf_counter_ns), `parent` (a Span, or None at the top),
    `attrs`, and `device_ms`, the device time between its ends of a span
    opened with `device=` (set by `drain()`; None otherwise)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs",
                 "device_ms", "_tracer", "_device", "_events")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 device=None):
        self.name, self.attrs, self.parent = name, attrs, None
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None
        self._tracer, self._device, self._events = tracer, device, None

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"{self.attrs!r}, device_ms={self.device_ms!r})")

    def __enter__(self) -> "Span":
        if self._device is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        stack = self._tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        tracer = self._tracer
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
            tracer._pending.add(self._device)
        tracer._stack().pop()
        tracer.spans.append(self)
        return None


class Tracer:
    """Spans in memory, on time.perf_counter_ns; off until `enable()`.
    `spans` holds the closed spans in the order they closed."""

    def __init__(self):
        self.on = False
        self.spans: list = []
        self._local = threading.local()
        self._pending: set = set()   # devices with device spans to read

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device=False, **attrs):
        """A context manager over a block, yielding the Span (or, off,
        the shared no-op).  device: False; or the device (True: the
        current CUDA device) whose current stream the span also times
        with CUDA events, where it is a CUDA device."""
        if not self.on:
            return _OFF
        cuda = torch.cuda.is_available()
        if cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"span {name!r} inside a CUDA graph capture")
        if device is True:
            device = "cuda" if cuda else None
        dev = torch.device(device) if device else None
        return Span(self, name, attrs,
                    dev if dev is not None and dev.type == "cuda" else None)

    def record(self, name: str, start_ns: int, end_ns: int,
               **attrs) -> None:
        """A closed span whose start was read earlier; its parent is the
        innermost span open now."""
        if not self.on:
            return
        s = Span(self, name, attrs)
        stack = self._stack()
        s.parent = stack[-1] if stack else None
        s.start_ns, s.end_ns = start_ns, end_ns
        self.spans.append(s)

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def drain(self) -> list:
        """The spans recorded so far, which the tracer forgets; each
        device span's `device_ms` read (after a sync of its device), and
        each attribute set to a device tensor read to a number or list
        (counts kept on the device, read here and not where they were
        set)."""
        for dev in self._pending:
            torch.cuda.synchronize(dev)
        self._pending = set()
        out, self.spans = self.spans, []
        for s in out:
            if s._events is not None:
                s.device_ms = s._events[0].elapsed_time(s._events[1])
                s._events = None
            for k, v in s.attrs.items():
                if isinstance(v, torch.Tensor):
                    s.attrs[k] = v.tolist()
        return out


TRACER = Tracer()
span = TRACER.span
record = TRACER.record
enable = TRACER.enable
disable = TRACER.disable
drain = TRACER.drain


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in nested tuples, lists, dicts and
    dataclasses (host ints and other leaves count nothing)."""
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def memory_snapshot(device=None) -> Optional[dict]:
    """The caching allocator's counters whose names hold "bytes" or
    "limit" (`torch.cuda.memory_stats`), or None on the CPU."""
    device = torch.device(device) if device is not None else None
    if not torch.cuda.is_available() or (device is not None
                                         and device.type != "cuda"):
        return None
    stats = torch.cuda.memory_stats(device)
    return {k: v for k, v in stats.items() if "bytes" in k or "limit" in k}


# The cache counters are host ints in the engine's caches, int32 scalars
# in the JAX package's (and (B,) int32 tensors in the port's slot
# caches): the report counts 4 bytes for each, as the JAX one does.
_COUNTER_BYTES = 4


def _cache_bytes(caches) -> int:
    return sum(tensor_bytes(c) + _COUNTER_BYTES * sum(
        isinstance(getattr(c, f.name), int) for f in dataclasses.fields(c))
        for c in caches)


def kv_cache_report(cfg, qcfg, batch: int, max_seq_len: int) -> dict:
    """Cache-memory model: bytes of the KIVI cache against an fp16 cache
    at the same batch and length, per batch and per sequence, and the
    implied max-batch multiplier.  The caches are built on the `meta`
    device: shapes and dtypes, nothing allocated."""
    from kivi_tpu_torch.models import modeling

    kivi = modeling.init_caches(cfg, qcfg, batch, max_seq_len,
                                device="meta")
    fp = modeling.init_caches(
        cfg, dataclasses.replace(qcfg, k_bits=16, v_bits=16), batch,
        max_seq_len, device="meta")
    kb, fb = _cache_bytes(kivi), _cache_bytes(fp)
    return {
        "kivi_bytes": kb,
        "fp16_bytes": fb,
        "memory_reduction": fb / kb,
        "kivi_bytes_per_seq": kb // batch,
        "fp16_bytes_per_seq": fb // batch,
    }
