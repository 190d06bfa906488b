"""Synthetic K/V tensors with the channel-outlier structure KIVI exploits:
port of `kivi_tpu/evalsuite/synth.py`.

The KIVI paper's motivating observation: in real LLMs the KEY cache has
a few channels whose magnitude is persistently 5-50x larger than the
rest (per-channel structure, stable across tokens), while the VALUE
cache shows no channel structure.  That is why KIVI quantizes K
per-channel (groups along tokens) and V per-token (groups along
channels).  This module synthesizes K/V with that structure, so that
accuracy probes measure the regime the algorithm was designed for.

The draws come from an explicit `torch.Generator` in place of the JAX
module's `jax.random` keys, so the streams differ from the JAX ones; the
structure is the same (tests/test_torch_evalsuite.py holds it).  The
tensors are made on the generator's device.
"""

from __future__ import annotations

import torch


def outlier_profile(generator: torch.Generator, D: int,
                    outlier_frac: float = 0.03,
                    outlier_scale: float = 12.0) -> torch.Tensor:
    """(D,) f32 per-channel magnitude profile: a lognormal body and
    max(1, round(D * outlier_frac)) distinct channels boosted by about
    outlier_scale."""
    kw = dict(generator=generator, device=generator.device)
    body = torch.exp(0.4 * torch.randn(D, **kw))
    n_out = max(1, int(round(D * outlier_frac)))
    idx = torch.randperm(D, **kw)[:n_out]
    boost = outlier_scale * torch.exp(0.3 * torch.randn(n_out, **kw))
    body[idx] *= boost
    return body


def structured_kv(generator: torch.Generator, B: int, H: int, T: int,
                  D: int, outlier_frac: float = 0.03,
                  outlier_scale: float = 12.0):
    """(k, v) of shape (B, H, T, D), f32.

    k: per-channel scaled noise plus a persistent per-channel mean (the
       outlier channels are large in both mean and spread); the token
       axis is iid given the channel profile.
    v: iid normal (no channel structure: per-token groups see the same
       distribution everywhere).
    """
    kw = dict(generator=generator, device=generator.device)
    prof = torch.stack([outlier_profile(generator, D, outlier_frac,
                                        outlier_scale)
                        for _ in range(H)])                   # (H, D)
    mean = prof * torch.randn(H, D, **kw)                     # fixed sign
    noise = torch.randn(B, H, T, D, **kw)
    k = mean[None, :, None, :] + prof[None, :, None, :] * 0.3 * noise
    v = torch.randn(B, H, T, D, **kw)
    return k.float(), v.float()
