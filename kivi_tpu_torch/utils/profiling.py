"""Tracing and memory accounting: port of `kivi_tpu/utils/profiling.py`.

  * `trace(logdir)`: `torch.profiler` around a block, written to
    `logdir/trace.json` as a Chrome trace (chrome://tracing, Perfetto);
  * `annotate(name)`: a labelled range inside such a trace;
  * `tensor_bytes(tree)`: bytes of the tensors of a parameter or cache
    structure (the JAX package's `pytree_bytes`);
  * `memory_snapshot()`: the CUDA caching allocator's byte counters, or
    None where there is no CUDA device;
  * `kv_cache_report(...)`: bytes of the KIVI cache against the fp16
    cache, from the shapes `models.modeling.init_caches` allocates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from kivi_tpu_torch.utils.timing import leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context (host ops, and CUDA kernels
    where there is a device); write `logdir/trace.json` on exit.  Yields
    the `torch.profiler.profile` object (`key_averages()` for sums)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Label a region inside a profiler trace."""
    return record_function(name)


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
