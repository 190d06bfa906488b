"""Where the port's entry points run.

Every public constructor (caches, parameters, the engine) takes a
`device` argument and resolves it here: CUDA unless the caller asks for
something else.  This module has no JAX counterpart (the JAX package
places arrays on its default backend).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for the
    CPU.  Without CUDA, a caller that did not ask for the CPU gets an
    error, never a silent run on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the plain versions on the host")
        return torch.device("cuda")
    return torch.device(device)
