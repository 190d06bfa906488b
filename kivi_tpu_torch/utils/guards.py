"""Debug-mode numerical guards: port of `kivi_tpu/utils/guards.py`.

The hot path stays guard-free: on the card the decode step is captured
once as a CUDA graph and replayed, so any check inside it would cost
every step, and a check that reads the device cannot be captured at
all.  `Engine(debug=True)` runs its entry points eagerly under
`checked_call` instead, the port's `checked_jit`: a NaN or Inf in a
call's logits or in the K/V values it appends to the caches, or a
violated caller contract (the decode kernels' `t_bound`), raises at the
call site with the layer and the check named, instead of silently
propagating garbage tokens.

`debug_check` is staged only inside a checked call (a context-variable
flag, as the JAX package scopes its flag to the checkified trace).
Outside one it returns at once: it reads nothing from the device and
launches nothing.  Inside one, a check whose predicate is a device
tensor is kept pending, and the call reads all of its pending checks
back in one transfer when it returns (as checkify carries its error
state to the end of the program); the first that failed raises.  A
host value (an int counter, a CPU tensor) is checked at once.  A
checked call is never captured into a CUDA graph, as `checked_jit`
drops donation.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, List, Optional

import torch

# The pending checks of the innermost checked call, or None outside one.
_PENDING: contextvars.ContextVar[Optional[List]] = contextvars.ContextVar(
    "kivi_torch_checked_call", default=None)


class GuardError(RuntimeError):
    """A failed debug check (the JAX package raises checkify's
    JaxRuntimeError)."""


def checking() -> bool:
    """True inside a checked call."""
    return _PENDING.get() is not None


def _fmt(msg: str, fmt: dict) -> str:
    vals = {k: (v.item() if isinstance(v, torch.Tensor) else v)
            for k, v in fmt.items()}
    return msg.format(**vals)


def debug_check(pred, msg: str, **fmt) -> None:
    """Check `pred` inside a checked call; a no-op outside one.

    pred: a bool or a one-element bool tensor (a call site whose
    predicate costs work guards it with `checking()`).  msg: a
    str.format template over fmt, whose values may be tensors (read only
    if the check fails)."""
    pending = _PENDING.get()
    if pending is None:
        return
    if isinstance(pred, torch.Tensor) and pred.is_cuda:
        pending.append((pred.reshape(()).to(torch.bool), msg, fmt))
    elif not bool(pred):
        raise GuardError(_fmt(msg, fmt))


def check_finite(x: torch.Tensor, what: str) -> None:
    """debug_check that every value of x is finite; `what` names the
    layer and the tensor."""
    if checking():
        debug_check(torch.isfinite(x).all(),
                    "non-finite value (nan or inf) in {what}", what=what)


def _raise_pending(pending: List) -> None:
    if not pending:
        return
    ok = torch.stack([p for p, _, _ in pending]).cpu()   # one read
    for good, (_, msg, fmt) in zip(ok.tolist(), pending):
        if not good:
            raise GuardError(_fmt(msg, fmt))


def checked_call(fn: Callable) -> Callable:
    """fn run eagerly with its debug checks staged; raises GuardError
    naming the first check that failed, after fn returns."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        pending: List = []
        token = _PENDING.set(pending)
        try:
            out = fn(*args, **kwargs)
        finally:
            _PENDING.reset(token)
        _raise_pending(pending)
        return out

    return run
