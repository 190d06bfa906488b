"""The shared-prefix decode route: single-token decode attention over a
batch whose rows hold the same quantized positions [0, shared), as the
engine's own caches do behind a fanned-out `PrefixSnapshot`.

Two launches a layer:

  * the prefix pass (`decode_prefix`, wrapper of `csrc/kdec_prefix.cuh`,
    entry `kivi_decode_prefix` of `csrc/fused_decode_rows.cu`): every
    row's queries against batch row 0's copy of [0, shared), read once
    per KV head, on the tensor cores; it returns the partial flash state
    of each of its splits;
  * row 6 (`fused_decode.fused_decode_attention(prefix=, shared=)`) over
    each row's own positions at or above `shared`, merging those
    partials before its own splits.

`shared_decode_attention` is the route; on CPU tensors it runs the two
plain versions, and on the fanned-out caches it computes
`fused_decode_attention_plain`'s function.  The prefix pass replaces no
TPU kernel (its source says why it was added and what bounds it).

Rows are folded per KV head: row b * r + rr of a head holds qg[b, :, rr].
The pass's partials are acc (Hkv, n, B * r, D) and ml (Hkv, n, B * r, 2)
f32 ((m, l) pairs: the scaled logits' max and the sum of exp(s - m)), n
splits; a row that sees nothing in a split has (0, NEG_INF, 0).  The
plain version returns one split.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels.fused_decode import fused_decode_attention
from kivi_tpu_torch.kernels.fused_decode_wide import NEG_INF

CHUNK = 64    # positions per chunk of the pass (csrc PX_CK)
ROWS = 128    # query rows per block of the pass (csrc PX_ROWS)


def shared_positions(n_k_quant: int, n_v_quant: int,
                     group_size: int) -> int:
    """The positions a route over caches fanned out from one snapshot
    may read once: the snapshot's quantized keys and values, the fewer
    of the two, rounded down to whole key groups and whole chunks of the
    pass.  Both stores only grow by appending, so these positions stay
    bit-equal in every row while the rows decode."""
    step = math.lcm(int(group_size), CHUNK)
    return min(int(n_k_quant), int(n_v_quant)) // step * step


def split_plan(shared: int, rows: int, heads: int, sms: int) -> tuple:
    """(chunks a split, splits) of the pass over [0, shared): enough
    splits that its blocks, one an SM, fill the card about twice over."""
    nch = shared // CHUNK
    tiles = -(-rows // ROWS) * heads
    want = min(nch, max(1, -(-2 * sms // tiles)))
    cps = -(-nch // want)
    return cps, -(-nch // cps)


@functools.lru_cache(maxsize=4)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_prefix_plain(qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                        *, shared: int, group_size: int, k_bits: int,
                        v_bits: int, lo: Optional[torch.Tensor] = None
                        ) -> tuple:
    """qg (B, Hkv, r, D) against batch row 0's store over [0, shared), in
    f32: (acc (Hkv, 1, B*r, D), ml (Hkv, 1, B*r, 2)), the logits scaled
    by 1/sqrt(D), row b's masked below lo[b]."""
    B, H, r, D = qg.shape
    q = qg.float().permute(1, 0, 2, 3).reshape(H, B * r, D)
    k = Q.dequantize_k(k_codes[:1], k_scale[:1], k_mn[:1], group_size,
                       k_bits)[0, :, :, :shared]
    v = Q.dequantize_v(v_codes[:1], v_scale[:1], v_mn[:1], group_size,
                       v_bits)[0, :, :shared]
    s = torch.einsum("hid,hdt->hit", q, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(shared, device=qg.device)
    valid = torch.ones((B * r, shared), dtype=torch.bool, device=qg.device)
    if lo is not None:
        lo_i = lo.to(device=qg.device, dtype=torch.int64).repeat_interleave(r)
        valid = pos[None] >= lo_i[:, None]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    m = torch.where(l > 0, m, torch.full_like(m, NEG_INF))
    acc = torch.einsum("hit,htd->hid", p, v)
    return acc[:, None], torch.stack([m, l], dim=-1)[:, None]


def decode_prefix(qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, *,
                  shared: int, group_size: int, k_bits: int, v_bits: int,
                  lo: Optional[torch.Tensor] = None) -> tuple:
    """The prefix pass; see decode_prefix_plain for the contract.  On
    CUDA: qg bf16, scales bf16 or f32, all 16-byte aligned, D <= 128 a
    multiple of 16, group_size a power of two >= 8, shared a multiple of
    CHUNK and of group_size; lo a (B,) int32 device tensor (read on the
    device).  Blocks over (ROWS-row query tiles, Hkv, split_plan's
    splits), bf16 operands and f32 accumulation on the tensor cores; the
    partials of every split are returned for row 6 to merge."""
    shared = int(shared)
    if not qg.is_cuda:
        return decode_prefix_plain(
            qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
            shared=shared, group_size=group_size, k_bits=k_bits,
            v_bits=v_bits, lo=lo)
    name = "decode_prefix"
    B, H, r, D = qg.shape
    Tmax, gs, sdt = k_codes.shape[-1], group_size, k_scale.dtype
    if (D > 128 or D % 16 or D % gs or gs < 8 or gs & (gs - 1)
            or Tmax % gs or not 0 < shared <= Tmax or shared % CHUNK
            or shared % gs):
        raise ValueError(f"{name}: unsupported D={D} gs={gs} Tmax={Tmax} "
                         f"shared={shared}")
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
    })
    _build.check_aligned(name, qg, k_codes, k_scale, k_mn, v_codes,
                         v_scale, v_mn)
    if lo is not None:
        lo = lo.to(device=qg.device, dtype=torch.int32).contiguous()
        if lo.shape != (B,):
            raise ValueError(f"{name}: lo must have shape ({B},)")
    cps, n = split_plan(shared, B * r, H, _sms(qg.device))
    f32 = dict(dtype=torch.float32, device=qg.device)
    acc = torch.empty((H, n, B * r, D), **f32)
    ml = torch.empty((H, n, B * r, 2), **f32)
    err = _build.library("fused_decode_rows").kivi_decode_prefix(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), _build.ptr(lo), acc.data_ptr(), ml.data_ptr(), B,
        H, r, D, Tmax, gs, k_bits, v_bits, shared, cps, n,
        int(sdt == torch.float32), 1.0 / math.sqrt(D),
        _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return acc, ml


def shared_decode_attention(
        qg, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win, v_win,
        counts: torch.Tensor, *, shared: int, group_size: int, k_bits: int,
        v_bits: int, lo: Optional[torch.Tensor] = None,
        t_bound: Optional[int] = None) -> torch.Tensor:
    """`fused_decode.fused_decode_attention`'s function over caches whose
    rows hold bit-equal quantized positions [0, shared) (the caller's
    contract: every row's n_k_quant and n_v_quant are at least shared,
    and those positions are row 0's): the prefix pass over row 0's copy,
    then row 6 over each row's own positions, merging the two.
    (B, Hkv, r, D) f32.  shared = 0 is row 6 alone."""
    kw = dict(group_size=group_size, k_bits=k_bits, v_bits=v_bits, lo=lo)
    if not shared:
        return fused_decode_attention(qg, k_codes, k_scale, k_mn, v_codes,
                                      v_scale, v_mn, k_win, v_win, counts,
                                      t_bound=t_bound, **kw)
    prefix = decode_prefix(qg, k_codes, k_scale, k_mn, v_codes, v_scale,
                           v_mn, shared=shared, **kw)
    return fused_decode_attention(qg, k_codes, k_scale, k_mn, v_codes,
                                  v_scale, v_mn, k_win, v_win, counts,
                                  t_bound=t_bound, prefix=prefix,
                                  shared=shared, **kw)
