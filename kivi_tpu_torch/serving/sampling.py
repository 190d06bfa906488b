"""Sampling transforms with HuggingFace `generate()` semantics: port of
`kivi_tpu/serving/sampling.py`: the static controls the engine uses and
the per-row controls of the continuous batcher (`*_per_row`), where
each slot carries its own temperature, top_k, top_p and penalty as
device tensors.

  * repetition penalty (CTRL): for every token id already in the
    sequence, logit > 0 -> logit / p, logit <= 0 -> logit * p.
  * temperature: logits / t.
  * top-k: keep the k largest logits, others -> -inf.
  * top-p: sort descending, keep the smallest prefix whose softmax mass
    reaches top_p (always >= 1 token), others -> -inf.

Order as in HF: penalty before the warpers, warpers in temperature ->
top_k -> top_p order.  Draws come from an explicit torch.Generator, so
sampled tokens differ from the JAX package's (jax.random) draws; the
distributions are the same.  Both samplers draw as
`jax.random.categorical` does, by Gumbel-max (argmax of the warped
logits plus Gumbel noise from one `torch.rand`): that never raises on a
row whose logits are all masked, and it can be captured in a CUDA graph
(`torch.multinomial` reads its probabilities back to the host to check
them, which a capture refuses).
"""

from __future__ import annotations

from typing import Optional

import torch

FILTER_VALUE = -float("inf")


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits (B, V) f32; seen (B, V) bool mask of token ids present in
    the sequence so far."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def apply_repetition_penalty_per_row(logits: torch.Tensor,
                                     seen: torch.Tensor,
                                     penalty: torch.Tensor) -> torch.Tensor:
    """Per-row penalty values (B,) (the batcher's variant); rows with
    penalty 1.0 are unchanged by construction."""
    pen = penalty.to(dtype=torch.float32).reshape(-1, 1)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen, penalized, logits)


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the top_k largest logits per row."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, FILTER_VALUE)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering (min_tokens_to_keep=1): keep tokens while the
    softmax mass of STRICTLY higher-ranked tokens is < top_p."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    prev = torch.cumsum(probs, dim=-1) - probs
    n_keep = (prev < top_p).sum(dim=-1, keepdim=True)         # >= 1
    thr = torch.gather(sorted_logits, -1, n_keep - 1)
    return logits.masked_fill(logits < thr, FILTER_VALUE)


def warp_logits(logits: torch.Tensor, *, temperature: float,
                top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """HF warper chain on raw logits (..., V); temperature > 0."""
    logits = logits / temperature
    logits = apply_top_k(logits, top_k)
    return apply_top_p(logits, top_p)


def gumbel_argmax(lt: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """A draw from softmax(lt) per row of lt (B, V): argmax of lt plus
    Gumbel noise from `generator` (B,) int64."""
    u = torch.rand(lt.shape, generator=generator, device=lt.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(lt - torch.log(-torch.log(u)), dim=-1)


def sample_step(logits: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0) -> torch.Tensor:
    """One sampling decision from raw logits (B, V) -> token ids (B,)
    int32.  temperature == 0 is greedy (argmax)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lt = warp_logits(logits.float(), temperature=temperature, top_k=top_k,
                     top_p=top_p)
    return gumbel_argmax(lt, generator).to(torch.int32)


def warp_logits_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Per-row warper chain (temperature -> top_k -> top_p) on (B, V)
    logits, every control a (B,) tensor: rank masking replaces the static
    top-k, the nucleus threshold follows apply_top_p.  Rows with
    temperature <= 0 are warped at t = 1 (callers handle greedy rows);
    rows with top_k <= 0 / top_p >= 1 are unfiltered."""
    B, V = logits.shape
    t = temperature.to(torch.float32).reshape(B, 1)
    k = top_k.to(torch.int64).reshape(B, 1)
    p = top_p.to(torch.float32).reshape(B, 1)
    lt = logits / torch.where(t <= 0.0, 1.0, t)

    order = torch.argsort(-lt, dim=-1, stable=True)     # descending
    ranks = torch.argsort(order, dim=-1, stable=True)    # rank of each logit
    lt = lt.masked_fill(ranks >= torch.where(k > 0, k, V), FILTER_VALUE)

    sorted_lt = torch.gather(lt, -1, order)
    probs = torch.softmax(sorted_lt, dim=-1)
    prev = torch.cumsum(probs, dim=-1) - probs
    n_keep = (prev < p).sum(dim=-1, keepdim=True)        # >= 1
    # index -1 (a row of NaN probabilities) wraps to the last rank, as
    # jnp.take_along_axis does
    thr = torch.gather(sorted_lt, -1, torch.remainder(n_keep - 1, V))
    return lt.masked_fill(lt < thr, FILTER_VALUE)


def probs_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling distribution: softmax of the warped logits for
    sampled rows, a one-hot at the argmax for greedy rows (temperature
    <= 0)."""
    B, V = logits.shape
    t = temperature.to(torch.float32).reshape(B, 1)
    w = torch.softmax(warp_logits_per_row(logits, temperature, top_k,
                                          top_p), dim=-1)
    hot = torch.nn.functional.one_hot(torch.argmax(logits, -1), V).to(
        w.dtype)
    return torch.where(t <= 0.0, hot, w)


def sample_step_per_row(logits: torch.Tensor,
                        generator: Optional[torch.Generator],
                        temperature: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling controls, the continuous batcher's variant: each
    row carries its own (temperature, top_k, top_p); temperature <= 0
    rows are greedy.  Sampled rows draw argmax(warped logits + Gumbel
    noise) from `generator` (jax.random.categorical's method).  Returns
    token ids (B,) int32."""
    greedy = temperature.reshape(-1) <= 0.0
    lt = warp_logits_per_row(logits.float(), temperature, top_k, top_p)
    sampled = gumbel_argmax(lt, generator)
    return torch.where(greedy, torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)


def seen_mask_from_prompt(tokens: torch.Tensor, vocab_size: int,
                          pad_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(B, T) prompt ids -> (B, V) bool mask for the repetition penalty.
    Left-pad slots (index < pad_len[b]) are excluded."""
    B, T = tokens.shape
    live = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    if pad_len is not None:
        idx = torch.arange(T, device=tokens.device)[None, :]
        live = idx >= pad_len.reshape(B, 1)
    # int32: CUDA has no bool scatter_reduce
    seen = torch.zeros((B, vocab_size), dtype=torch.int32,
                       device=tokens.device)
    return seen.scatter_reduce(1, tokens.long(), live.to(torch.int32),
                               reduce="amax").bool()


def update_seen(seen: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Mark newly generated token ids (B,) in the (B, V) mask."""
    return seen.scatter(1, token.long().reshape(-1, 1), True)
