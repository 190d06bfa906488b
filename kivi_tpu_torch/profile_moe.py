"""Row 13 of the kernel table, the grouped expert GEMM
(`csrc/moe_grouped.cu`, kernels/moe_grouped.py), at the K-EXAONE cell's
shapes on one GPU.

    python3 -m kivi_tpu_torch.profile_moe [--tokens 256 32000]

For each token count N: hidden 6144, expert width 2048, 16 experts held
(0-15) of 128, 8 chosen a token by the top 8 of random scores (seeded),
random bf16 weights at 1 / sqrt(fan-in).  Each launch of
`moe_grouped.experts` after the routing is first held to its plain
version run on the card on the same inputs (`hold`), then timed
(`utils.timing.cuda_ms`, the median of single calls after an L2 scrub):
the kernel, the plain version, and as the library's yardstick the same
launch through `torch._grouped_mm` with the device offsets (the SiLU
product, the weights and the scatter in torch), where this torch has it,
else one cuBLAS product an expert (the offsets read on the host first).
Each launch's bound is the least time of what it must move and compute
on the H100's published peaks: the hit experts' weights once, its input
rows and its output rows (`gate_up`: x's rows in, h's out, 2 x 2 x 6144
x 2048 operations a pair; `down`: h's rows in, the f32 rows it adds out,
2 x 2048 x 6144 a pair).  Prints one line per N and launch, the card's
name and power limit, and a JSON object last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import moe_grouped as MG
from kivi_tpu_torch.utils import tolerance as TOL
from kivi_tpu_torch.utils.device import card
from kivi_tpu_torch.utils.timing import bound, cuda_ms

HD, IE, E_ALL, HELD, K = 6144, 2048, 128, 16, 8

# `gate_up` against its plain version, each row of h within GATE_RTOL of
# the row's largest value: both take exact bf16 products into f32 sums
# (in another order, ~1e-6 apart) and round h to bf16 once, so an
# element differs by at most one bf16 step, 2**-8 to 2**-7 of itself.
# `down`, given the same h, differs by the order of f32 sums alone (2048
# products a pair, a token's pairs added atomically): DOWN_RTOL of each
# token's largest value.  A row computed with the wrong expert's weights,
# or missing one of its 64 K slices, is off by a tenth of the row or more
# (`hold`'s control moves one pair to the next expert and must fail).
GATE_RTOL = 2.0 ** -7
DOWN_RTOL = 1e-3


def inputs(n: int, seed: int = 0, skew: bool = False, first: int = 0):
    """(x, idx, w, wg, wu, wd) of n tokens.  skew: every token also
    chooses held experts `first` and `first` + 1 (n pairs each, several
    row tiles) and none chooses the last two held experts (no pair)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0):
        return (torch.randn(s, generator=g, device="cuda") * scale).to(
            torch.bfloat16)

    x = rn(n, HD)
    scores = torch.rand(n, E_ALL, generator=g, device="cuda")
    if skew:
        scores[:, first:first + 2] += 2.0
        scores[:, first + HELD - 2:first + HELD] -= 2.0
    idx = torch.topk(scores, K, dim=-1).indices
    w = scores.gather(1, idx).clamp_min(1e-3)
    w = w / w.sum(-1, keepdim=True) * 2.5
    wg, wu = rn(HELD, HD, IE, scale=HD ** -0.5), rn(HELD, HD, IE,
                                                    scale=HD ** -0.5)
    wd = rn(HELD, IE, HD, scale=IE ** -0.5)
    return x, idx, w, wg, wu, wd


def _moved(off: torch.Tensor, counts: list) -> torch.Tensor:
    """off with the last pair of the first expert that has one moved to
    the expert after it: the control a per-row check must refuse."""
    e = next(i for i, c in enumerate(counts[:-1]) if c)
    bad = off.clone()
    bad[e + 1] -= 1
    return bad


def hold(x, idx, w, wg, wu, wd, first: int = 0, what: str = "") -> dict:
    """Each launch against its plain version on the same inputs (`down`
    on the kernel's own h), row by row at GATE_RTOL / DOWN_RTOL, each
    beside a control that moves one pair to the next expert and must
    fail; raises otherwise.  Returns the worst rows' shares of their
    limits, the controls', and the largest |kernel - plain|."""
    tok, ws, off, counts, P = MG.plan(idx, w, first, wg.shape[0])
    c = counts.tolist()
    held = sum(c)
    h = MG.gate_up(x, tok, off, wg, wu, P)
    h_plain = MG.gate_up_plain(x, tok, off, wg, wu, P)
    out = torch.zeros(x.shape[0], wd.shape[-1], dtype=torch.float32,
                      device=x.device)
    MG.down(h, tok, ws, off, wd, out)
    want = torch.zeros_like(out)
    MG.down_plain(h, tok, ws, off, wd, want)
    bad = _moved(off, c)
    h_ctrl = MG.gate_up_plain(x, tok, bad, wg, wu, P)
    ctrl = torch.zeros_like(out)
    MG.down_plain(h, tok, ws, bad, wd, ctrl)
    res = {"pairs": held, "experts_hit": sum(1 for v in c if v),
           "counts_min_max": [min(c), max(c)]}
    for name, got, ref, cref, rtol in (
            ("gate_up", h[:held], h_plain[:held], h_ctrl[:held], GATE_RTOL),
            ("down", out, want, ctrl, DOWN_RTOL)):
        err, share = TOL.check_rows(got, ref, rtol, f"{what} {name}")
        refused = TOL.row_share(cref, ref, rtol).max().item()
        if not refused > 1:
            raise AssertionError(f"{what} {name}: the check passed a pair "
                                 f"moved to the next expert ({refused:.3f} "
                                 "of the limit)")
        res[name] = {"max_abs_err": err, "worst_share": share,
                     "control_share": refused}
    return res


def _gathered_mm(off, grouped: bool):
    """The products of each expert's rows with its weights: torch's own
    grouped product over the device offsets, or a cuBLAS loop."""
    if grouped:
        ends = off[1:]
        return lambda a, b: torch._grouped_mm(a, b, offs=ends)
    bounds = off.tolist()

    def mm(a, b):
        out = a.new_zeros(a.shape[0], b.shape[-1])
        for e, (s, t) in enumerate(zip(bounds, bounds[1:])):
            out[s:t] = a[s:t] @ b[e]
        return out
    return mm


def _library(x, tok, ws, off, wg, wu, wd, h, P, grouped: bool) -> tuple:
    """(gate_up, down) through the library: the same launches' work."""
    mm = _gathered_mm(off, grouped)
    # the pairs past the held ones (experts held elsewhere) add nothing
    live = (torch.arange(P, device=x.device) < off[-1])[:, None]

    def gate_up():
        xg = x.index_select(0, tok[:P].long())
        return F.silu(mm(xg, wg)) * mm(xg, wu)

    def down():
        y = torch.where(live, mm(h, wd).float() * ws[:P, None], 0.0)
        out = torch.zeros(x.shape[0], wd.shape[-1], dtype=torch.float32,
                          device=x.device)
        out.index_add_(0, tok[:P].long(), y)
        return out
    return gate_up, down


def _yardstick(args) -> tuple:
    """(name, (gate_up, down)) of the library's route: torch._grouped_mm
    where this torch has it and takes these operands, else the cuBLAS
    loop."""
    if hasattr(torch, "_grouped_mm"):
        try:
            fns = _library(*args, grouped=True)
            for f in fns:
                f()
            return "torch._grouped_mm", fns
        except (RuntimeError, TypeError) as e:
            print(f"[moe] torch._grouped_mm refused: {e}", flush=True)
    return "cuBLAS loop", _library(*args, grouped=False)


def bounds(pairs: int, hit: int) -> dict:
    """{launch: (bound ms, "bytes" or "operations")} (module
    docstring)."""
    return {"gate_up": bound(2 * (hit * 2 * HD * IE + pairs * (HD + IE)),
                             2 * pairs * 2 * HD * IE),
            "down": bound(2 * (hit * IE * HD + pairs * IE) + 4 * pairs * HD,
                          2 * pairs * IE * HD)}


def measure(n: int, seed: int = 0, plain_iters: int = 2) -> dict:
    """`hold` at n tokens, then each launch's ms, plain ms, library ms
    and bound (module docstring)."""
    x, idx, w, wg, wu, wd = inputs(n, seed)
    t = {"tokens": n, **hold(x, idx, w, wg, wu, wd, what=f"N={n}")}
    tok, ws, off, counts, P = MG.plan(idx, w, 0, HELD)
    h = MG.gate_up(x, tok, off, wg, wu, P)
    lib_name, (lib_gu, lib_dn) = _yardstick((x, tok, ws, off, wg, wu, wd,
                                             h, P))
    out = torch.zeros(n, HD, dtype=torch.float32, device="cuda")
    fns = {"gate_up": (lambda: MG.gate_up(x, tok, off, wg, wu, P),
                       lambda: MG.gate_up_plain(x, tok, off, wg, wu, P),
                       lib_gu),
           "down": (lambda: MG.down(h, tok, ws, off, wd, out),
                    lambda: MG.down_plain(h, tok, ws, off, wd, out),
                    lib_dn)}
    lim = bounds(t["pairs"], t["experts_hit"])
    t["library"] = lib_name
    for name, (kern, plain, lib) in fns.items():
        bms, by = lim[name]
        t[name].update(ms=cuda_ms(kern), plain_ms=cuda_ms(
            plain, iters=plain_iters, warmup=0), library_ms=cuda_ms(lib),
            bound_ms=bms, bound_by=by)
    return t


def run(token_counts=(256, 32000)) -> dict:
    out = {"card": card()}
    for n in token_counts:
        t = out[f"N{n}"] = measure(n)
        for name in ("gate_up", "down"):
            r = t[name]
            print(f"[moe] N={n} {name}: pairs {t['pairs']}, kernel "
                  f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']}), plain {r['plain_ms']:.3f}, library "
                  f"{r['library_ms']:.4f} ({t['library']}); worst row at "
                  f"{r['worst_share']:.3f} of its limit, the control at "
                  f"{r['control_share']:.1f} | {out['card']}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, nargs="+", default=[256, 32000])
    a = ap.parse_args(argv)
    out = run(tuple(a.tokens))
    # registers, shared memory and spills of each kernel (ptxas -v)
    print(_build.BUILD_LOG.get("moe_grouped", ""))
    print(out["card"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
