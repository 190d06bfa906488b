"""The held experts of a sparse-expert layer over the tokens routed to
them: wrapper of `csrc/moe_grouped.cu` (row 13 of the kernel table; it
replaces no TPU kernel, its source says why it was added) and its plain
version.

`experts(x, idx, w, wg, wu, wd, first)`: x (N, Hd) tokens, idx (N, k)
the experts each token chose (global indices) and w (N, k) f32 their
weights; wg, wu (E, Hd, I) and wd (E, I, Hd) the held experts first ..
first + E - 1.  Returns (N, Hd) in x's dtype: the sum, over each token's
choices that are held here, of w * down(silu(x gate) * (x up)).

Everything stays on the device and no count reaches the host, so a CUDA
graph can replay it (`plan`): the (token, choice) pairs are sorted by
held expert (a sort and a scatter-add of ones; the pairs of experts held
elsewhere sort last), each expert's pairs are [off[e], off[e + 1]), and
the two launches take a static bound on their row tiles from the batch's
shape alone, their blocks past the last tile exiting at once:

  * `gate_up`: h[p] = silu(x[tok[p]] @ wg[e]) * (x[tok[p]] @ wu[e]),
    rounded once to x's dtype, the rows of x gathered inside the load;
  * `down`: out[tok[p]] += w[p] * (h[p] @ wd[e]) in f32.

`plan` also returns the tokens on each held expert, which the caller may
log (`ExpertLog`).

A CPU tensor takes the plain versions (every expert over every row under
a mask: no host read either); a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kivi_tpu_torch.kernels import _build

BN = 64        # columns of a tile (csrc BN)
BK = 32        # K depth of a slice (csrc BK)
SMALL = 32     # pairs of a row tile at decode (csrc BM)
LARGE = 128    # pairs of a row tile at prefill


def plan(idx: torch.Tensor, w: torch.Tensor, first: int, held: int):
    """The pairs sorted by held expert: (tok (N*k,) int32 token of each
    sorted pair, ws (N*k,) f32 its weight, off (held + 1,) int32 the
    experts' bounds, counts (held,) int32 the pairs on each), and P, the
    static bound on the held pairs (N * min(k, held))."""
    N, k = idx.shape
    local = idx - first
    here = (local >= 0) & (local < held)
    key = torch.where(here, local, held).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(held + 1, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    off = torch.cat([counts.new_zeros(1),
                     torch.cumsum(counts[:held], 0, dtype=torch.int32)])
    tok = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    ws = w.reshape(-1).float().index_select(0, order)
    return tok, ws, off, counts[:held], N * min(k, held)


def row_tiles(P: int, held: int, bm: int) -> int:
    """The static bound on the row tiles of bm pairs: every pair in full
    tiles plus a partial tile an expert."""
    return -(-P // bm) + held


def _rows_of(off: torch.Tensor, P: int):
    """(P, E) bool: row p of the sorted pairs belongs to expert e."""
    p = torch.arange(P, device=off.device)[:, None]
    return (p >= off[None, :-1]) & (p < off[None, 1:])


def gate_up_plain(x, tok, off, wg, wu, P: int) -> torch.Tensor:
    """h (P, I) in x's dtype; rows past the held pairs are 0."""
    xg = x.index_select(0, tok[:P].long()).float()
    rows = _rows_of(off, P)
    h = torch.zeros((P, wg.shape[-1]), dtype=torch.float32, device=x.device)
    for e in range(wg.shape[0]):
        he = F.silu(xg @ wg[e].float()) * (xg @ wu[e].float())
        h = torch.where(rows[:, e:e + 1], he, h)
    return h.to(x.dtype)


def down_plain(h, tok, ws, off, wd, out) -> None:
    """out (N, Hd) f32 += each held pair's weighted down projection."""
    P = h.shape[0]
    rows = _rows_of(off, P)
    y = torch.zeros((P, wd.shape[-1]), dtype=torch.float32, device=h.device)
    for e in range(wd.shape[0]):
        y = torch.where(rows[:, e:e + 1], h.float() @ wd[e].float(), y)
    out.index_add_(0, tok[:P].long(), y * ws[:P, None])


def _bm(P: int, held: int) -> int:
    """The row tile of a call: small while the bound on an expert's pairs
    is a few small tiles (decode: 128 at 256 tokens), large above."""
    return SMALL if P <= 8 * SMALL * held else LARGE


def gate_up(x, tok, off, wg, wu, P: int) -> torch.Tensor:
    if not x.is_cuda:
        return gate_up_plain(x, tok, off, wg, wu, P)
    name = "moe_grouped_gate_up"
    E, K, I = wg.shape
    bm = _bm(P, E)
    _check(name, x, (x.shape[0], K), {"wg": (wg, (E, K, I)),
                                      "wu": (wu, (E, K, I))}, K, I)
    h = torch.empty((P, I), dtype=x.dtype, device=x.device)
    err = _build.library("moe_grouped").kivi_moe_grouped_gate_up(
        x.data_ptr(), tok.data_ptr(), off.data_ptr(), wg.data_ptr(),
        wu.data_ptr(), h.data_ptr(), E, K, I, row_tiles(P, E, bm), bm,
        _build.stream_handle(x.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return h


def down(h, tok, ws, off, wd, out) -> None:
    if not h.is_cuda:
        return down_plain(h, tok, ws, off, wd, out)
    name = "moe_grouped_down"
    E, I, Hd = wd.shape
    P = h.shape[0]
    bm = _bm(P, E)
    _check(name, h, (P, I), {"wd": (wd, (E, I, Hd))}, I, Hd)
    if out.dtype != torch.float32 or not out.is_contiguous() or \
            out.shape[1] != Hd:
        raise ValueError(f"{name}: out must be a contiguous f32 (N, {Hd})")
    err = _build.library("moe_grouped").kivi_moe_grouped_down(
        h.data_ptr(), tok.data_ptr(), ws.data_ptr(), off.data_ptr(),
        wd.data_ptr(), out.data_ptr(), E, I, Hd, row_tiles(P, E, bm), bm,
        _build.stream_handle(h.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1


def _check(name, a, a_shape, weights: dict, K: int, N: int) -> None:
    if K % BK or N % BN:
        raise ValueError(f"{name}: K={K} must be a multiple of {BK} and "
                         f"N={N} of {BN}")
    _build.check_tensors(name, a.device, dict(
        {"a": (a, a_shape, torch.bfloat16)},
        **{k: (t, s, torch.bfloat16) for k, (t, s) in weights.items()}))
    _build.check_aligned(name, a, *(t for t, _ in weights.values()))


def experts(x, idx, w, wg, wu, wd, first: int, log=None) -> torch.Tensor:
    """The held experts' part of the layer's output (module docstring);
    log: an `ExpertLog` that gets the tokens on each held expert."""
    tok, ws, off, counts, P = plan(idx, w, first, wg.shape[0])
    if log is not None:
        log.add(counts)
    h = gate_up(x, tok, off, wg, wu, P)
    out = torch.zeros((x.shape[0], wd.shape[-1]), dtype=torch.float32,
                      device=x.device)
    down(h, tok, ws, off, wd, out)
    return out.to(x.dtype)


class ExpertLog:
    """The tokens on each held expert, one row per expert-layer call, on
    the device: `add` writes row n % cap and advances n, in place and
    with no host read (a replayed step logs each replay).  `clear` and
    `calls` (a host read of the rows kept) are for a caller outside the
    graphs; `totals(since)` reduces the calls from `since` (an earlier
    `n.clone()`) on to (pairs routed here, the most on one expert in one
    call, held experts left without a token summed over calls) as a (3,)
    device tensor, read whenever its caller reads."""

    def __init__(self, experts: int, device, cap: int = 8192):
        self.cap = cap
        self.rows = torch.zeros((cap, experts), dtype=torch.int32,
                                device=device)
        self.n = torch.zeros(1, dtype=torch.int64, device=device)

    def add(self, counts: torch.Tensor) -> None:
        self.rows.index_copy_(0, self.n % self.cap, counts[None])
        self.n += 1

    def clear(self) -> None:
        self.n.zero_()

    def calls(self) -> list:
        n = int(self.n)
        rows = self.rows[:min(n, self.cap)].cpu().tolist()
        return rows if n <= self.cap else rows[n % self.cap:] + \
            rows[:n % self.cap]

    def totals(self, since: torch.Tensor) -> torch.Tensor:
        age = (self.n - 1 - torch.arange(self.cap, device=self.n.device)
               ) % self.cap
        live = (age < torch.clamp(self.n - since, max=self.cap))[:, None]
        rows = torch.where(live, self.rows, 0)
        idle = (live & (self.rows == 0)).sum()
        return torch.stack([rows.sum().long(), rows.max().long(),
                            idle.long()])
