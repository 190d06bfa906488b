"""Single-token decode attention over the KIVI cache: wrapper of
`csrc/fused_decode.cu` (port of `kivi_tpu/kernels/fused_decode_wide.py`)
and its plain version.

The plain version is the JAX package's split two-half softmax
(`kivi_tpu/core/attention.py:156-216`): logits over the dequantized K
store and the fp K window, one softmax over their concatenation, PV over
the dequantized V store plus the fp V window with V routed by position
(`_gather_v_window_probs`).  The kernel computes the same function split
over T (`csrc/kdec_split.cuh`): one exact softmax per SPLIT-position
split, the partials (m, l, acc) merged in split order.

`_ablate` is the JAX kernel's profiling hook
(`kivi_tpu/kernels/fused_decode_wide.py:77-86`; its profiler is
`kivi_tpu_torch/profile_attribution.py`): one part of the work taken
out, each name a variant of the same kernel (`kdec::Ablation`, launched
from `csrc/trimmed.cu`) whose function the plain version states exactly
(`ABLATIONS`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build

NEG_INF = -1e30

# _ablate name -> the kdec::Ablation variant the kernel runs with its fp
# windows live (csrc/trimmed.cu, kivi_wide_ablate), and the function:
#   window   no window phase: softmax over the store's positions, PV over
#            the V store only (the strip [n_v_quant, n_k_quant) and the
#            window add nothing); the JAX branch's function
#   chunk    no quantized-store body: softmax and PV over the window's
#            positions alone; the JAX branch's function
#   vquant   the V store's product dropped (the window's and the strip's
#            kept); the JAX branch's function
#   qk       store logits q . mn + sum_d c_d s_d (variant 5 of
#            kernels/trimmed.py), the rest full; the JAX branch instead
#            zeroes the store's logits and drops the strip's product
#   kunpack  every code of a word read as its low `bits` bits (variant
#            6), the rest full; the JAX branch reads stale scratch
#   compute  every load issued and landed (the window rows read into
#            registers), nothing computed: zeros
ABLATIONS = {"window": 8, "chunk": 9, "vquant": 10, "qk": 5, "kunpack": 6,
             "compute": 11}


def _gather_v_window_probs(p_a: torch.Tensor, p_b: torch.Tensor,
                           n_k_quant: int, n_v_quant: int,
                           W: int) -> torch.Tensor:
    """Route probabilities of positions [n_v_quant, seq_len) onto value-
    window rows [0, n_v_win).  Position i sits in p_a at slot i when
    i < n_k_quant, else in p_b at slot i - n_k_quant.  Entries beyond the
    valid counts are exact zeros (their logits were masked), so the two
    contributions can simply be added."""
    lead = p_a.shape[:-1]
    delta = n_k_quant - n_v_quant                       # in [0, W]
    pad = p_a.new_zeros((*lead, W))
    a_part = torch.cat([p_a, pad], dim=-1)[..., n_v_quant:n_v_quant + W]
    b_part = p_b.new_zeros((*lead, 2 * W))
    b_part[..., delta:delta + W] = p_b
    return a_part + b_part[..., :W]


def fused_decode_attention_wide_plain(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        n_k_quant: int, n_k_win: int, n_v_quant: int, *, group_size: int,
        k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None,
        hi: Optional[int] = None,
        _ablate: Optional[str] = None) -> torch.Tensor:
    """qg (B, Hkv, r, D) + cache arrays -> (B, Hkv, r, D) f32.  lo: (B,)
    int lower position bound per row (left pad / sliding window); hi:
    positions at or past it are not attended (the per-row kernel's
    t_bound).  _ablate: one of ABLATIONS, the function stated there (a
    row with no live position gives zeros)."""
    _check_ablate(_ablate)
    B, Hkv, r, D = qg.shape
    Tmax = k_codes.shape[-1]
    W = k_win.shape[2]
    sm_scale = 1.0 / math.sqrt(D)
    dev = qg.device
    q = qg.float()
    if _ablate == "compute":
        return torch.zeros((B, Hkv, r, D), dtype=torch.float32, device=dev)

    pos_q = torch.arange(Tmax, device=dev)
    win = torch.arange(W, device=dev)
    att_q = _store_logits(q, k_codes, k_scale, k_mn, group_size, k_bits,
                          _ablate)
    att_q = att_q.masked_fill((pos_q >= n_k_quant) | (_ablate == "chunk"),
                              NEG_INF)
    att_w = torch.einsum("bhrd,bhwd->bhrw", q, k_win.float())
    att_w = att_w.masked_fill((win >= n_k_win) | (_ablate == "window"),
                              NEG_INF)
    if hi is not None:
        att_q = att_q.masked_fill(pos_q >= hi, NEG_INF)
        att_w = att_w.masked_fill(win + n_k_quant >= hi, NEG_INF)
    if lo is not None:
        lo4 = lo.to(device=dev, dtype=torch.int64).reshape(B, 1, 1, 1)
        att_q = att_q.masked_fill(pos_q < lo4, NEG_INF)
        att_w = att_w.masked_fill(win + n_k_quant < lo4, NEG_INF)

    att = torch.cat([att_q, att_w], dim=-1)
    live = att > NEG_INF / 2
    att = att * sm_scale
    att = att - att.amax(dim=-1, keepdim=True)
    p = torch.exp(att).masked_fill(~live, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    p_a, p_b = p[..., :Tmax], p[..., Tmax:]

    p_vq = p_a.masked_fill((pos_q >= n_v_quant) | (_ablate == "vquant"),
                           0.0)
    v_deq = Q.dequantize_v(v_codes, v_scale, v_mn, group_size, v_bits)
    out_q = torch.einsum("bhrt,bhtd->bhrd", p_vq, v_deq)
    p_vw = _gather_v_window_probs(p_a, p_b, n_k_quant, n_v_quant, W)
    if _ablate == "window":
        p_vw = torch.zeros_like(p_vw)
    out_w = torch.einsum("bhrw,bhwd->bhrd", p_vw, v_win.float())
    return out_q + out_w


def _check_ablate(name: Optional[str]) -> None:
    if name is not None and name not in ABLATIONS:
        raise ValueError(f"_ablate={name!r} is not one of "
                         f"{sorted(ABLATIONS)}")


def _store_logits(q, k_codes, k_scale, k_mn, group_size: int, k_bits: int,
                  ablate: Optional[str]) -> torch.Tensor:
    """q (B, H, r, D) f32 against the K store -> (B, H, r, Tmax): q . k
    over the dequantized keys; ablate "qk": q . mn + sum_d c_d s_d;
    "kunpack": the keys of codes read as each word's low `bits` bits
    (kernels/trimmed.py, variants 5 and 6)."""
    if ablate not in ("qk", "kunpack"):
        k_deq = Q.dequantize_k(k_codes, k_scale, k_mn, group_size, k_bits)
        return torch.einsum("bhrd,bhdt->bhrt", q, k_deq)
    D, Dw, T = q.shape[-1], k_codes.shape[2], k_codes.shape[-1]
    grp = torch.arange(T, device=q.device) // group_size
    sc = k_scale.float().transpose(-1, -2)[..., grp]       # (B, H, D, T)
    mn = k_mn.float().transpose(-1, -2)[..., grp]
    if ablate == "qk":
        codes = Q.unpack_codes(k_codes, k_bits, axis=-2).float()
        return (torch.einsum("bhrd,bhdt->bhrt", q, mn)
                + (codes * sc).sum(dim=2)[:, :, None])
    # crumbs: channel j*(2Dw) + 2w + h sits in word w; planes: j*Dw + w
    d = torch.arange(D, device=q.device)
    word = (d % (2 * Dw)) // 2 if k_bits < 8 else d % Dw
    codes = (k_codes[:, :, word] & ((1 << k_bits) - 1)).float()
    return torch.einsum("bhrd,bhdt->bhrt", q, codes * sc + mn)


_CHUNK = 128          # positions per chunk of the CUDA kernel
SPLIT = 256           # positions per block of the CUDA kernel (csrc S)
_ROWS = (1, 2, 4, 8)  # query rows per KV head the kernel is built for


def split_plan(n_end: int) -> int:
    """Splits of the host-int kernel: SPLIT-position splits from position
    0 (the lower bound `lo` lives on the device, so no split is skipped
    by the host) up to n_end = n_k_quant + n_k_win, at least one."""
    return max(1, -(-int(n_end) // SPLIT))


def _check_cuda(name, qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                k_win, v_win, group_size, k_bits, v_bits):
    """Raise unless the CUDA kernel takes these inputs."""
    B, H, r, D = qg.shape
    Tmax, W, gs = k_codes.shape[-1], k_win.shape[2], group_size
    sdt = k_scale.dtype
    if (r not in _ROWS or D > 128 or D % 8 or 256 % D or D % gs
            or _CHUNK % gs or gs % 2 or Tmax % 8 or Tmax % gs):
        raise ValueError(f"{name}: unsupported r={r} D={D} gs={gs} "
                         f"Tmax={Tmax}")
    if k_bits not in (2, 4, 8) or v_bits not in (2, 4, 8):
        raise ValueError(f"{name}: bits must be 2, 4 or 8")
    if sdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: scales must be bf16 or f32, got {sdt}")
    _build.check_tensors(name, qg.device, {
        "qg": (qg, (B, H, r, D), torch.bfloat16),
        "k_codes": (k_codes, (B, H, Q.num_words(D, k_bits), Tmax),
                    torch.int32),
        "k_scale": (k_scale, (B, H, Tmax // gs, D), sdt),
        "k_mn": (k_mn, (B, H, Tmax // gs, D), sdt),
        "v_codes": (v_codes, (B, H, Q.num_words(D, v_bits), Tmax),
                    torch.int32),
        "v_scale": (v_scale, (B, H, D // gs, Tmax), sdt),
        "v_mn": (v_mn, (B, H, D // gs, Tmax), sdt),
        "k_win": (k_win, (B, H, W, D), torch.bfloat16),
        "v_win": (v_win, (B, H, W, D), torch.bfloat16),
    })
    _build.check_aligned(name, k_codes, k_scale, k_mn, v_codes, v_scale,
                         v_mn, k_win, v_win)


def fused_decode_attention_wide(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        n_k_quant: int, n_k_win: int, n_v_quant: int, *, group_size: int,
        k_bits: int, v_bits: int,
        lo: Optional[torch.Tensor] = None,
        _ablate: Optional[str] = None) -> torch.Tensor:
    """qg (B, Hkv, r, D) + KiviLayerCache arrays -> (B, Hkv, r, D) f32.

    Counters are host ints of a cache state (0 <= n_k_win <= W,
    n_k_quant + n_k_win <= Tmax, n_k_quant + n_k_win - W <= n_v_quant
    <= n_k_quant); lo is an optional (B,) int32 lower position bound.
    On CUDA: qg and the windows bf16, scales bf16 or f32, the cache
    arrays 16-byte aligned, r in (1, 2, 4, 8), D in (8, 16, 32, 64, 128), an even
    group_size dividing D and 128.  One launch: blocks over (split_plan
    SPLIT-position splits, B*Hkv), the last block of each head merging
    its splits in order.

    _ablate: a profiling variant (ABLATIONS), the same launch of the
    kernel with one part of the work taken out, from the probe's library
    (counted as "trimmed"); on CUDA at r = 1 with bf16 scales only."""
    _check_ablate(_ablate)
    if not qg.is_cuda:
        return fused_decode_attention_wide_plain(
            qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
            v_win, n_k_quant, n_k_win, n_v_quant, group_size=group_size,
            k_bits=k_bits, v_bits=v_bits, lo=lo, _ablate=_ablate)
    name = "fused_decode_attention_wide"
    if _ablate is not None:
        name = f"{name}(_ablate={_ablate!r})"
        if qg.shape[2] != 1 or k_scale.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the ablated variants are built for "
                             f"r = 1 and bf16 scales only")
    _check_cuda(name, qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                k_win, v_win, group_size, k_bits, v_bits)
    B, H, r, D = qg.shape
    Tmax, W = k_codes.shape[-1], k_win.shape[2]
    nkq, nkw, nvq = int(n_k_quant), int(n_k_win), int(n_v_quant)
    if not (0 <= nkw <= W and 0 <= nkq and nkq + nkw <= Tmax
            and max(nkq + nkw - W, 0) <= nvq <= nkq):
        raise ValueError(f"{name}: counters (n_k_quant, n_k_win, "
                         f"n_v_quant) = {(nkq, nkw, nvq)} are no cache "
                         f"state of Tmax={Tmax}, W={W}")
    if lo is not None:
        lo = lo.to(device=qg.device, dtype=torch.int32).contiguous()
        if lo.shape != (B,):
            raise ValueError(f"{name}: lo must have shape ({B},)")
    out = torch.empty((B, H, r, D), dtype=torch.float32, device=qg.device)
    part_acc, part_ml, tickets = _build.workspace(
        qg.device, B * H, split_plan(Tmax), r, D)
    args = (qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
            k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
            v_mn.data_ptr(), k_win.data_ptr(), v_win.data_ptr(),
            _build.ptr(lo), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), tickets.data_ptr(), B, H, r, D, Tmax, W,
            group_size, k_bits, v_bits, nkq, nkw, nvq)
    tail = (SPLIT, split_plan(nkq + nkw), 1.0 / math.sqrt(D),
            _build.stream_handle(qg.device))
    if _ablate is None:
        err = _build.library("fused_decode").kivi_fused_decode(
            *args, int(k_scale.dtype == torch.float32), *tail)
        counted = "fused_decode_attention_wide"
    else:
        err = _build.library("trimmed").kivi_wide_ablate(
            *args, ABLATIONS[_ablate], *tail)
        counted = "trimmed"
    _build.check(err, name)
    _build.LAUNCHES[counted] += 1
    return out
