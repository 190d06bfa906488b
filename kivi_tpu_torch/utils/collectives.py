"""The two tensor-parallel collectives the model layer issues: a sum
after the row-parallel projections and the vocab-split logits' gather.
torch.distributed only, so the model imports nothing of the parallel
tier (`kivi_tpu_torch/parallel/`); a group of None issues nothing."""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over a tensor-parallel group, in place (no-op for None)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate x's last dim over a group, in rank order: a copy, so
    every rank holds the same bits (no-op for None)."""
    if group is None:
        return x
    n = group.size()
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.view((n,) + tuple(x.shape))
    return out.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (-1,))
