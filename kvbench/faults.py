"""Faults planted under the timed path, for the measurements that show the
check fails what it must (tools.py readings --fault, and the CPU tests).
Each is planted before the program is built, so that a captured CUDA
graph holds it too; `plant` returns the function that takes it out.

    skip-append    a decode step leaves the KV cache as it was: no window
                   append, no flush, no counter moved (the engine's and
                   the batcher's decode); the step's tokens still flow
    stale-window   a decode step moves its counters but writes no key or
                   value into the window (the slice-sized masked writes
                   of the replayed decode step)
    frozen-step    a whole decode step returns its state unchanged: the
                   engine's decode body does nothing, the batcher's step
                   hands back the previous tokens
    altered-token  every sampled or greedy token is replaced by the next
                   id where it is produced
"""

from __future__ import annotations

FAULTS = ("skip-append", "stale-window", "frozen-step", "altered-token")


def _altered(fn):
    def wrapped(logits, *a, **kw):
        tok = fn(logits, *a, **kw)
        return ((tok.long() + 1) % logits.shape[-1]).to(tok.dtype)
    return wrapped


def plant(name: str):
    """Plant the fault `name`; returns the undo."""
    from kivi_tpu_torch.cache import kivi_cache
    from kivi_tpu_torch.serving import sampling
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher
    from kivi_tpu_torch.serving.engine import Engine
    if name == "skip-append":
        patches = [(kivi_cache, "decode_append_masked",
                    lambda cache, *a, **kw: cache),
                   (kivi_cache, "decode_append",
                    lambda cache, *a, **kw: cache)]
    elif name == "stale-window":
        patches = [(kivi_cache, "masked_store_write",
                    lambda *a, **kw: None)]
    elif name == "frozen-step":
        patches = [(Engine, "_decode_body", lambda *a, **kw: None),
                   (ContinuousBatcher, "_decode_all",
                    lambda self, fill_bound=None: self.nxt)]
    elif name == "altered-token":
        patches = [(sampling, f, _altered(getattr(sampling, f)))
                   for f in ("sample_step", "sample_step_per_row")]
    else:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, fn in patches:
        setattr(obj, attr, fn)

    def undo():
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return undo
