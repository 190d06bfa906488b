"""How the tensor-core attention kernels are held to their plain versions.

`flash_attention`, `flash_extend_attention` and `flash_extend_qhist` run
their products with bf16 operands and f32 accumulation, as the Pallas
kernels do; their plain versions compute in f32.  Each query row is held
to its own scale, never to the largest value of the whole output: a
row's output is a weighted mean of values, and rows that average many
keys come out an order of magnitude smaller than a row that sees a
handful, so a whole-tensor scale would let a late row lose a chunk of
its keys unseen.

Per row: max over d |got - want| <= rtol * max over d |want| + ATOL.

FLASH_RTOL: q, k, v are bf16 already; p is rounded to bf16 before PV
(2^-9 relative) and the output once (2^-9), so a row's largest error is
about 2^-8 of its largest value; 4 * 2^-8 leaves room for the tail of
~10^5 rows.

QHIST_RTOL: adds the dequantized operands.  K^ = code * scale is rounded
to bf16 relative to itself, and code * scale spans the group's whole
range, a few times |k| (the zero point is added apart, in f32), so the
logits carry ~2^-8 absolute noise; V^ = code * scale + mn is rounded
once.  The kernel's state is rescaled to the plain version's max before
acc and l are compared (the pair (acc, l) is defined up to the factor
exp(m)); m, an absolute logit, is held to the largest |m| of the output.

EXTEND_RTOL: the full extend kernel rounds as qhist does over the
history (K^ = code * scale with q . mn apart, V^ = code * scale + mn, p),
and over the fp window and its own causal block only p (k, v and q are
bf16 already); its output is normalized in f32 and not rounded.  So the
same 8 * 2^-8 of each row's largest value, for the same reasons: the
dequantized operands' rounding, relative to the group's whole range,
dominates a row that attends the history.

tests/test_torch_tolerance.py models the kernels' rounding on the CPU
and holds it within half of each limit, and checks that a control which
drops one chunk of keys is refused.
"""

from __future__ import annotations

import torch

FLASH_RTOL = 4 * 2.0 ** -8
QHIST_RTOL = 8 * 2.0 ** -8
EXTEND_RTOL = 8 * 2.0 ** -8
ATOL = 1e-5
NEG_INF = -1e30


def row_share(got, want, rtol: float) -> torch.Tensor:
    """Each row's max|got - want| over its share of the limit (> 1
    fails): rows are all dims but the last."""
    g, w = got.float(), want.float()
    return (g - w).abs().amax(-1) / (rtol * w.abs().amax(-1) + ATOL)


def check_rows(got, want, rtol: float, what: str):
    """Raise unless every row is within its limit and got is finite.
    Returns (max|got - want|, the worst row's share of its limit)."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    share = row_share(got, want, rtol)
    worst = share.max().item() if share.numel() else 0.0
    if worst > 1:
        i = int(share.argmax())
        w = want.float().reshape(-1, want.shape[-1])[i]
        e = (got.float().reshape(-1, got.shape[-1])[i] - w).abs().max()
        raise AssertionError(
            f"{what}: row {i}: max|kernel - plain| = {e.item():.3e} > "
            f"{rtol:.4g} * {w.abs().max().item():.3e} + {ATOL}")
    return (got.float() - want.float()).abs().max().item(), worst


def state_shares(got, want, rtol: float) -> dict:
    """Worst share of its limit of acc, l and m of a flash state (acc
    (..., D), m (...), l (...)) against the plain one, over the rows the
    plain state calls live (m > NEG_INF); the kernel's acc and l are first
    rescaled by exp(m - m_plain)."""
    acc, m, l = got
    acc_w, m_w, l_w = want
    live = m_w != NEG_INF
    if not live.any():
        return dict(acc=0.0, m=0.0, l=0.0)
    f = torch.exp(m[live] - m_w[live])
    m_lim = rtol * m_w[live].abs().max() + ATOL
    return dict(
        acc=row_share(acc[live] * f[:, None], acc_w[live], rtol).max().item(),
        l=((l[live] * f - l_w[live]).abs()
           / (rtol * l_w[live] + ATOL)).max().item(),
        m=((m[live] - m_w[live]).abs() / m_lim).max().item())


def check_state(got, want, rtol: float, what: str):
    """Raise unless the rows that see nothing are exactly (0, NEG_INF, 0)
    in both states and the rest are within state_shares' limits.  Returns
    (max|acc - acc_plain|, the worst share, the number of empty rows)."""
    acc, m, l = got
    acc_w, m_w, _ = want
    empty = m_w == NEG_INF
    if not (torch.equal(m == NEG_INF, empty) and (l[empty] == 0).all()
            and (acc[empty] == 0).all()):
        raise AssertionError(f"{what}: empty rows are not (0, -1e30, 0)")
    if not all(torch.isfinite(t).all() for t in (acc, l)):
        raise AssertionError(f"{what}: non-finite values")
    shares = state_shares(got, want, rtol)
    worst = max(shares.values())
    if worst > 1:
        raise AssertionError(f"{what}: share of the limit {shares} > 1 "
                             f"(rtol {rtol:.4g})")
    return ((acc - acc_w).abs().max().item(), worst, int(empty.sum()))
