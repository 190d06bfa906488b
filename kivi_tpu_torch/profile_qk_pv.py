"""Piece-by-piece times of the split decode kernels (`csrc/qk_pv.cu`,
rows 7 and 8) at the long slice's shape, on one GPU.

    python3 -m kivi_tpu_torch.profile_qk_pv [--batch 1 4] [--nq 12000]

Builds `csrc/qk_pv.cu` once per value of its KIVI_QKPV_PROBE switch (the
header of that file says what each takes out), beside the kernels' own
build, all in parallel, and times `qk_dequant_matmul` and
`pv_dequant_matmul` through each build (`utils.timing.cuda_ms`, twice
each) at batch B, 8 KV heads, r = 4, D = 128, KIVI-2 with group 32 and
bf16 scales: a T = 16384 store quantized from N(0, 1) on the card with
n_quant positions live, p a softmax over them.  The builds that compute
the kernels' function ("kernels", "generic", "element") are first held
to the plain versions at chip_smoke.py's ATT_RTOL.  Prints one line per
(batch, build), the card's name and power limit, and a JSON object
last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import qk_pv as QP
from kivi_tpu_torch.utils.device import card
from kivi_tpu_torch.utils.timing import cuda_ms

# build name -> KIVI_QKPV_PROBE
BUILDS = {"kernels": 0, "empty": 1, "loads only": 2, "no merge": 3,
          "generic": 4, "element": 5}
EXACT = ("kernels", "generic", "element")
H, R, D, GS, BITS, T = 8, 4, 128, 32, 2, 16384
RTOL = ATOL = 1e-5


def inputs(batch: int, nq: int, seed: int = 0):
    """(q, K store, V store, p) at the long slice's shape on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    kc, ks, km = Q.quantize_k_block(rn(batch, H, D, T), GS, BITS)
    vc, vs, vm = Q.quantize_v_block(rn(batch, H, T, D), GS, BITS)
    bf = lambda x: x.to(torch.bfloat16).contiguous()  # noqa: E731
    q = rn(batch, H, R, D).to(torch.bfloat16)
    pos = torch.arange(T, device="cuda")
    p = torch.softmax(rn(batch, H, R, T).masked_fill(pos >= nq,
                                                     float("-inf")), dim=-1)
    return (q, (kc.contiguous(), bf(ks), bf(km), GS, BITS),
            (vc.contiguous(), bf(vs), bf(vm), GS, BITS), p)


def _close(got, want, what: str) -> None:
    err = (got - want).abs().max().item()
    if not err <= RTOL * want.abs().max().item() + ATOL:
        raise AssertionError(f"{what}: max|kernel - plain| = {err:.3e}")


def run(batches=(1, 4), nq: int = 12000) -> dict:
    libs = _build.build_probes("qk_pv", {
        name: [f"-DKIVI_QKPV_PROBE={k}"] if k else []
        for name, k in BUILDS.items()})
    out = {"card": card()}
    for batch in batches:
        q, kargs, vargs, p = inputs(batch, nq)
        qk = lambda: QP.qk_dequant_matmul(q, *kargs, n_quant=nq)  # noqa
        pv = lambda: QP.pv_dequant_matmul(p, *vargs, n_quant=nq)  # noqa
        for name, lib in libs.items():
            with _build.through("qk_pv", lib):
                if name in EXACT:
                    _close(qk()[..., :nq], QP.qk_dequant_matmul_plain(
                        q, *kargs, n_quant=nq)[..., :nq], f"{name} qk")
                    _close(pv(), QP.pv_dequant_matmul_plain(
                        p, *vargs, n_quant=nq), f"{name} pv")
                t = {"qk_ms": [cuda_ms(qk) for _ in range(2)],
                     "pv_ms": [cuda_ms(pv) for _ in range(2)]}
            out[f"B{batch} {name}"] = t
            print(f"[qk_pv] B={batch} {name}: QK "
                  + ", ".join(f"{x:.5f}" for x in t["qk_ms"]) + " ms, PV "
                  + ", ".join(f"{x:.5f}" for x in t["pv_ms"])
                  + f" ms | {out['card']}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--nq", type=int, default=12000)
    a = ap.parse_args(argv)
    out = run(tuple(a.batch), a.nq)
    print(out["card"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
