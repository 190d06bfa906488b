"""Ablation probe of the KIVI decode kernel: wrapper of `csrc/trimmed.cu`
(port of `trimmed` in `scripts/profile_wide_32k.py`, the chunk phase of
`kivi_tpu/kernels/fused_decode_wide.py` under ablations) and its plain
version.

The kernel runs this port's decode body itself (`kdec::attend` of
`csrc/common.cuh`, the body of `csrc/fused_decode.cu` and
`csrc/fused_decode_rows.cu`): the walk over the quantized history at
full fill, no fp windows, no lower bound.  The body's ablation switches
(`kdec::Ablation`; variant 0 is the body the decode kernels run) take
out one part of the work at a time, so the time of the full body splits
into loads, unpack, scale application, QK and PV
(`kivi_tpu_torch.profile_wide_32k`).  Each variant computes a function
that `trimmed_plain` states exactly; only the full and `fold` variants
are attention, the others are timing probes.

Inputs are the port's cache layout: qg (B, H, r, D), codes (B, H, Dw, T)
int32, K scale/min (B, H, T//gs, D) rows, V scale/min (B, H, D//gs, T);
`n_quant` (a host int) positions of both stores are live.  The JAX probe
takes the K scales as (B, H, D, T//gs), the layout its production kernel
used before the cache stored rows.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels.fused_decode_wide import _CHUNK, _ROWS, NEG_INF

# (scales, do_qk, do_vpath, do_unpack) -> the kernel's variant (VAR of
# kdec::Ablation in csrc/common.cuh).
#   scales "element": q . (c * s + mn), the scale of each position's group;
#          "fold":    sum_d (q_d * s_d) * c + sum_d q_d * mn_d, the scale
#                     folded into the query rows once per group (the same
#                     function as "element");
#          "none":    the chunk's first scale row for every position.
#   do_qk False:      logit = q . mn + sum_d c_d * s_d.
#   do_vpath False:   out[..., :] = sum over chunk starts of p there.
#   do_unpack False:  every slot of a word reads its low `bits` bits.
VARIANTS = {
    ("element", True, True, True): 0,      # full: attention
    ("fold", True, True, True): 1,         # attention
    ("none", True, True, True): 2,
    ("element", True, False, True): 3,
    ("fold", True, False, True): 4,
    ("element", False, True, True): 5,
    ("element", True, True, False): 6,
    ("none", False, False, False): 7,      # loads only
}


def _variant(scales: str, do_qk: bool, do_vpath: bool,
             do_unpack: bool) -> int:
    key = (scales, bool(do_qk), bool(do_vpath), bool(do_unpack))
    if key not in VARIANTS:
        raise ValueError(f"trimmed: no variant (scales, do_qk, do_vpath, "
                         f"do_unpack) = {key}; see VARIANTS")
    return VARIANTS[key]


def trimmed_plain(qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                  n_quant: int, *, group_size: int, k_bits: int,
                  v_bits: int, scales: str = "element", do_qk: bool = True,
                  do_vpath: bool = True, do_unpack: bool = True,
                  chunk: int = _CHUNK) -> torch.Tensor:
    """qg (B, H, r, D) + quantized stores -> (B, H, r, D) f32.

    logits over positions < n_quant (scaled by 1/sqrt(D)) as the variant
    defines them (VARIANTS), one softmax, then PV over the dequantized V
    store, or with do_vpath=False the summed probability of the chunk
    starts (positions 0, chunk, 2*chunk, ...) broadcast over D.  chunk
    also places the first scale row of scales="none".  n_quant = 0 gives
    zeros."""
    _variant(scales, do_qk, do_vpath, do_unpack)
    B, H, r, D = qg.shape
    T, gs = k_codes.shape[-1], group_size
    dev = qg.device
    q = qg.float()
    pos = torch.arange(T, device=dev)
    if do_unpack:
        codes = Q.unpack_codes(k_codes, k_bits, axis=-2).float()
    else:                 # crumbs: channel j*(2Dw) + 2w + h sits in word w
        Dw = k_codes.shape[2]
        word = (torch.arange(D, device=dev) % (2 * Dw)) // 2
        codes = (k_codes[:, :, word] & ((1 << k_bits) - 1)).float()
    sc = k_scale.float().transpose(-1, -2)            # (B, H, D, T//gs)
    mn = k_mn.float().transpose(-1, -2)[..., pos // gs]
    sgrp = (pos // chunk * chunk if scales == "none" else pos) // gs
    zp = torch.einsum("bhrd,bhdt->bhrt", q, mn)
    if not do_qk:
        att = zp + (codes * sc[..., sgrp]).sum(dim=2)[:, :, None]
    elif scales == "fold":
        qs = q[..., None] * sc[:, :, None]            # (B, H, r, D, T//gs)
        att = zp + torch.einsum(
            "bhrdg,bhdgi->bhrgi", qs,
            codes.reshape(B, H, D, T // gs, gs)).reshape(B, H, r, T)
    else:
        att = torch.einsum("bhrd,bhdt->bhrt", q, codes * sc[..., sgrp] + mn)
    live = pos < int(n_quant)
    att = att.mul(1.0 / math.sqrt(D)).masked_fill(~live, NEG_INF)
    p = torch.exp(att - att.amax(dim=-1, keepdim=True)).masked_fill(~live,
                                                                    0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    if do_vpath:
        v = Q.dequantize_v(v_codes, v_scale, v_mn, gs, v_bits)
        return torch.einsum("bhrt,bhtd->bhrd", p, v)
    first = p.masked_fill(pos % chunk != 0, 0.0).sum(dim=-1, keepdim=True)
    return first.expand(B, H, r, D).contiguous()


def trimmed(qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
            n_quant: int, *, group_size: int, k_bits: int, v_bits: int,
            scales: str = "element", do_qk: bool = True,
            do_vpath: bool = True, do_unpack: bool = True) -> torch.Tensor:
    """The probe over positions < n_quant -> (B, H, r, D) f32, the
    function `trimmed_plain` states with chunk = 128.  On CUDA: qg and
    the scales bf16, bits 2 or 4, r in (1, 2, 4, 8), D <= 128,
    128 % group_size == 0."""
    var = _variant(scales, do_qk, do_vpath, do_unpack)
    if not qg.is_cuda:
        return trimmed_plain(qg, k_codes, k_scale, k_mn, v_codes, v_scale,
                             v_mn, n_quant, group_size=group_size,
                             k_bits=k_bits, v_bits=v_bits, scales=scales,
                             do_qk=do_qk, do_vpath=do_vpath,
                             do_unpack=do_unpack)
    name = "trimmed"
    B, H, r, D = qg.shape
    T, gs = k_codes.shape[-1], group_size
    if r not in _ROWS or D > 128 or D % gs or _CHUNK % gs or T % gs:
        raise ValueError(f"{name}: unsupported r={r} D={D} gs={gs} T={T}")
    if k_bits not in (2, 4) or v_bits not in (2, 4):
        raise ValueError(f"{name}: bits must be 2 or 4")
    nq = int(n_quant)
    if not 0 <= nq <= T:
        raise ValueError(f"{name}: n_quant={nq} outside [0, {T}]")
    bf = torch.bfloat16
    _build.check_tensors(name, qg.device, {
        "qg": (qg, (B, H, r, D), bf),
        "k_codes": (k_codes, (B, H, Q.num_words(D, k_bits), T), torch.int32),
        "k_scale": (k_scale, (B, H, T // gs, D), bf),
        "k_mn": (k_mn, (B, H, T // gs, D), bf),
        "v_codes": (v_codes, (B, H, Q.num_words(D, v_bits), T), torch.int32),
        "v_scale": (v_scale, (B, H, D // gs, T), bf),
        "v_mn": (v_mn, (B, H, D // gs, T), bf),
    })
    out = torch.empty((B, H, r, D), dtype=torch.float32, device=qg.device)
    err = _build.library("trimmed").kivi_trimmed(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), out.data_ptr(), B, H, r, D, T, gs, k_bits, v_bits,
        nq, var, 1.0 / math.sqrt(D), _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
