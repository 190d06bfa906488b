"""CUDA graphs of the decode step: the port's `jax.jit` for decode.

The JAX package never runs decode step by step from Python: its engine
runs decode as one jitted `lax.scan` and its batcher keeps one jitted
step per fill bound.  The port captures one decode step as a CUDA graph
(`torch.cuda.CUDAGraph`) per static key and replays it, so a step costs
the host one graph launch instead of a few thousand kernel launches.

A captured body reads and writes only tensors that outlive the graph at
fixed addresses (caches, counters, token and position buffers), updated
in place: a tensor rebound inside the body would leave the replay on
the old one, and a host read or a Python branch on a device value
cannot be captured.

`StepGraphs.run(key, body)` runs one step.  On a key's first use it
first runs the body eagerly on the capture stream: a real step, which
also builds the kernel libraries, allocates their cached workspaces,
loads the kernels' modules and sets their attributes, so that none of
that happens inside the capture.  Then it captures the body into the
owner's memory pool (shared by all of its graphs, which replay one at a
time on one stream).  Every later call replays.  A failed capture
raises: nothing falls back to eager.  The warm-up and the capture sit
in one `graphs.capture` span (utils/profiling.py); a replay has none of
its own, and no span may sit inside a body.

`kernels._build.LAUNCHES` counts launches by wrapper.  A capture
records launches without making them, so the counts the wrappers added
while capturing are taken back and added again on every replay.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, Iterable

import torch

from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.utils.profiling import span


class StepGraphs:
    """The captured decode steps of one owner (an Engine or a
    ContinuousBatcher) on one CUDA device, one graph per key."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self._graphs: Dict[Hashable, tuple] = {}

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        self._graphs.clear()

    def run(self, key: Hashable, body: Callable[[], None],
            generators: Iterable[torch.Generator] = ()) -> None:
        """One step: replay the graph captured for key, or on the key's
        first use run body eagerly (the warm-up) and capture it.
        generators: the non-default torch.Generators the body draws
        from, registered with the graph so that each replay draws fresh
        numbers, as an eager call would."""
        entry = self._graphs.get(key)
        if entry is not None:
            graph, launches = entry
            graph.replay()
            _build.LAUNCHES.update(launches)
            return
        with span("graphs.capture", key=repr(key)):
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                body()
            cur.wait_stream(self.stream)
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            before = collections.Counter(_build.LAUNCHES)
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                body()
            launches = _build.LAUNCHES - before
            _build.LAUNCHES.subtract(launches)
            self._graphs[key] = (graph, launches)
