"""Ring attention: sequence-parallel causal prefill over a process group,
port of `kivi_tpu/parallel/ring.py`.

The prompt's token axis is split over a group of n ranks, each holding
one contiguous T/n block of Q/K/V.  Attention runs as an n-step ring:
every step each rank contracts its Q block against the K/V block it
holds, folds the result into an online softmax accumulator (the flash
recurrence), and passes the K/V block, with the true positions of its
tokens, to rank i+1 while taking rank i-1's
(`dist.batch_isend_irecv`; a ring of 1 sends nothing).

Causality makes half the ring dead for the average rank: block j feeds
block i only when it holds a position <= one of i's.  A dead block is
skipped by the true positions it carries (the window too), so rank i
does i+1 live steps in the contiguous layout; the zigzag layout
(`zigzag_perm`) balances them.

Numerics, kept from the JAX package: f32 accumulation with the online
max / denominator recurrence over `score_chunk` chunks, the finite mask
value -1e30 (a row masked in a whole chunk folds exp(0) = 1 everywhere
and is zeroed by the later rescale exp(-1e30 - m)), and rank i folding
blocks in the order i, i-1, ...  So the port's ring agrees with the JAX
ring to f32 rounding (tests/test_torch_ring.py: 2e-5).  The body is
plain PyTorch, as the JAX one is `jnp.einsum` under `shard_map` with no
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_NEG = -1e30  # core/attention.py's mask value (finite: no NaN in exp)


def _block_attn(q, k, v, qpos, kpos, pad_len, sliding_window, scale):
    """One chunk's contraction: q (B,Hkv,r,Tl,D) f32 against k/v
    (B,Hkv,S,D); returns (the row sums of exp(s - m) (..,Tl), the local
    max m (..,Tl), exp(s - m) @ v (..,Tl,D))."""
    s = torch.einsum("bhrtd,bhsd->bhrts", q, k.float()) * scale
    mask = kpos[None, :] <= qpos[:, None]                 # causal
    if sliding_window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - sliding_window)
    # left pad: positions [0, pad) are garbage for that row
    mask = (mask[None, None, None]
            & (kpos[None, None, None, None, :]
               >= pad_len[:, None, None, None, None]))
    s = torch.where(mask, s, torch.full((), _NEG, device=s.device))
    m = s.amax(dim=-1)
    u = torch.exp(s - m[..., None])
    pv = torch.einsum("bhrts,bhsd->bhrtd", u, v.float())
    return u.sum(-1), m, pv


def _rotate(tensors, group):
    """Send each tensor to rank i+1 of the group and return the ones
    rank i-1 sent."""
    n, i = group.size(), group.rank()
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    got = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group=group) for t in tensors]
           + [dist.P2POp(dist.irecv, g, prv, group=group) for g in got])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return got


def ring_attention(q, k, v, group=None, *, sliding_window=None,
                   pad_len=None, positions=None, score_chunk=None):
    """Causal self-attention with the TOKEN axis split over `group`.

    q (B, Hq, Tl, D), k/v (B, Hkv, Tl, D): this rank's block of slots
    (rank i holds global slots [i*Tl, (i+1)*Tl)).  GQA by head-group
    fold (Hq = r * Hkv).  group: a process group, or None for a ring of
    one.  pad_len: optional (B,) left pads (the same on every rank).
    positions: optional (Tl,) int, the TRUE token index in each of this
    rank's slots; masking (causal, window, pad) is computed from them,
    so any token permutation is handled exactly.  None means the
    contiguous layout (slot s holds token s).  score_chunk bounds the
    scores held at once: each step scores the Q block against K in
    chunks of the largest divisor of Tl <= score_chunk (default 1024).
    Returns (B, Hq, Tl, D) in q.dtype."""
    n = 1 if group is None else group.size()
    i = 0 if group is None else group.rank()
    B, Hq, Tl, D = q.shape
    Hkv = k.shape[1]
    r = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    pad = (torch.zeros(B, dtype=torch.int64, device=dev) if pad_len is None
           else torch.as_tensor(pad_len, device=dev).reshape(B).long())
    qpos = (i * Tl + torch.arange(Tl, device=dev) if positions is None
            else torch.as_tensor(positions, device=dev).reshape(Tl).long())
    qg = q.float().reshape(B, Hkv, r, Tl, D)
    acc = torch.zeros((B, Hkv, r, Tl, D), dtype=torch.float32, device=dev)
    m_run = torch.full((B, Hkv, r, Tl), _NEG, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, Hkv, r, Tl), dtype=torch.float32, device=dev)
    req = score_chunk if score_chunk else 1024
    C = next(c for c in range(min(req, Tl), 0, -1) if Tl % c == 0)
    q_lo, q_hi = int(qpos.min()), int(qpos.max())
    kb, vb, kpos = k.contiguous(), v.contiguous(), qpos
    for t in range(n):
        # dead when every key of the block is past this rank's newest
        # query, or (window) before every query's window
        alive = int(kpos.min()) <= q_hi
        if sliding_window is not None:
            alive &= int(kpos.max()) > q_lo - sliding_window
        if alive:
            for c in range(0, Tl, C):
                u_sum, m_loc, pv = _block_attn(
                    qg, kb[:, :, c:c + C], vb[:, :, c:c + C], qpos,
                    kpos[c:c + C], pad, sliding_window, scale)
                m_new = torch.maximum(m_run, m_loc)
                a = torch.exp(m_run - m_new)     # rescale the accumulator
                b = torch.exp(m_loc - m_new)     # rescale this chunk
                acc = acc * a[..., None] + pv * b[..., None]
                l_run = l_run * a + u_sum * b
                m_run = m_new
        if t + 1 < n:
            kb, vb, kpos = _rotate((kb, vb, kpos), group)
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.reshape(B, Hq, Tl, D).to(q.dtype)


def zigzag_perm(T: int, n: int):
    """Load-balancing permutation for an n-rank ring over T tokens: 2n
    half-blocks, rank i holds halves (i, 2n-1-i), so each rank's causal
    work is ~constant instead of proportional to its rank.

    Returns (perm, inv) as int32 numpy arrays: `x_striped = x[perm]`
    lays out the striped order, `x = x_striped[inv]` undoes it, and
    `perm` itself is the per-slot true-position vector (rank i passes
    its block of it as ring_attention(positions=...)).  Requires
    T % (2 * n) == 0."""
    if T % (2 * n):
        raise ValueError(f"T={T} not divisible by 2*n={2 * n}")
    h = T // (2 * n)
    blocks = []
    for i in range(n):
        blocks.append(np.arange(i * h, (i + 1) * h))
        j = 2 * n - 1 - i
        blocks.append(np.arange(j * h, (j + 1) * h))
    perm = np.concatenate(blocks).astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)
    return perm, inv


@dataclasses.dataclass
class SeqGroup:
    """A sequence-parallel prefill's layout, what `modeling.forward(
    seq_group=)` needs: the group the prompt is split over (None: a
    ring of one), this rank's place in it, the true token index of each
    of this rank's slots (Tl,), the inverse permutation that puts the
    gathered slots back in token order ((T,), None for the contiguous
    layout), and the global slot of the last true token (T - 1 unless
    the layout is permuted)."""

    group: Optional[object]
    rank: int
    n: int
    positions: torch.Tensor
    inv: Optional[torch.Tensor]
    last_index: int

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, Tl, D): this rank's slots -> (B, H, T, D), every
        rank's slots in true token order."""
        if self.group is not None:
            x = x.contiguous()
            out = torch.empty((self.n * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=self.group)
            B, H, Tl, D = x.shape
            x = out.view(self.n, B, H, Tl, D).permute(1, 2, 0, 3, 4)
            x = x.reshape(B, H, self.n * Tl, D)
        if self.inv is not None:
            x = x.index_select(2, self.inv)
        return x

    @property
    def owner(self) -> int:
        """The rank holding the last true token's slot."""
        return self.last_index // self.positions.shape[0]

    def from_owner(self, x: Optional[torch.Tensor], shape, dtype,
                   device) -> torch.Tensor:
        """x, computed on the owner (None elsewhere), broadcast to every
        rank of the group."""
        if self.group is None:
            return x
        buf = (x.contiguous() if self.rank == self.owner
               else torch.empty(shape, dtype=dtype, device=device))
        dist.broadcast(buf, dist.get_global_rank(self.group, self.owner),
                       group=self.group)
        return buf


def seq_layout(T: int, group, striped: bool, device) -> SeqGroup:
    """The layout of a T-token prompt over `group` (None: one rank):
    contiguous blocks, or the zigzag order when striped."""
    n = 1 if group is None else group.size()
    rank = 0 if group is None else group.rank()
    if T % n:
        raise ValueError(f"prompt length {T} not divisible by the {n}-rank "
                         "sequence axis")
    Tl = T // n
    if striped:
        perm, inv = zigzag_perm(T, n)
        pos = torch.from_numpy(perm[rank * Tl:(rank + 1) * Tl]).long()
        return SeqGroup(group, rank, n, pos.to(device),
                        torch.from_numpy(inv).long().to(device),
                        int(inv[T - 1]))
    pos = torch.arange(rank * Tl, (rank + 1) * Tl)
    return SeqGroup(group, rank, n, pos.to(device), None, T - 1)
