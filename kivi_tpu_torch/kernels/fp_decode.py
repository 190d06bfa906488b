"""Single-token decode attention over the full-precision cache (the
fp16-cache baseline): wrapper of `csrc/fp_decode.cu` (port of
`fp_decode_attention_kernel` in `kivi_tpu/kernels/fp_decode.py`) and its
plain version.

The r query rows of each KV head attend cache positions p < length with
p >= pad_b (left pad) and, with a sliding window, p >= length - window.
`length` is a host int (the engine's host-int `decode_step`) or a (B,)
device tensor of per-row lengths (the continuous batcher's slot caches,
and the engine's caches during its decode).  With per-row
lengths, `t_bound` (the JAX kernel's, `kivi_tpu/kernels/fp_decode.py:
86-104`) is a static bound on every row's length fixed when a decode
step is captured: Tmax (the default) or a multiple of SPLIT below it.
Positions at or past it are neither read nor attended; where every
row's length is at most t_bound (the caller's contract) the result is
the unbounded one.
K is stored transposed, (B, H, D, Tmax); V is (B, H, Tmax, D).

The plain version is the Pallas body's function in f32: logits in f32
from the bf16 query and keys, probabilities kept in f32, and 0 for a row
with no admitted position (the `l > 0` guard).  It reads only the live
positions [0, length).  The JAX package's `impl="jnp"` oracle
(`kivi_tpu/cache/fp_cache.py:183-195`) rounds the query and the
probabilities (and, over a bf16 cache, the logits and the output) to
bf16 along the way, and the Pallas kernel rounds the probabilities to
bf16 before PV; the port rounds neither.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.kernels import _build

NEG_INF = -1e30
_ROWS = (1, 2, 4, 8)  # query rows per KV head the kernel is built for
SPLIT = 256           # positions per block of the kernel (csrc S)


def fp_decode_attention_plain(qg, k, v, length, *,
                              sliding_window: Optional[int] = None,
                              pad_len: Optional[torch.Tensor] = None,
                              t_bound: Optional[int] = None
                              ) -> torch.Tensor:
    """qg (B, H, r, D); k (B, H, D, Tmax); v (B, H, Tmax, D); length: host
    int count of valid positions, or a (B,) int tensor of per-row counts
    (the sliding window then counts back from each row's own length,
    and positions at or past t_bound are not attended).  Returns
    (B, H, r, D) f32."""
    B, H, r, D = qg.shape
    dev = qg.device
    tb = None
    if isinstance(length, torch.Tensor):
        Tmax = k.shape[-1]
        tb = _build.check_t_bound("fp_decode_attention_plain", t_bound,
                                  Tmax, SPLIT)
        hi = length.to(device=dev, dtype=torch.int64).clamp(
            0, Tmax).reshape(B, 1)
        # positions up to the longest row (a host read: the plain version
        # runs on the CPU), so uniform lengths sum as the host-int form
        T = max(int(hi.max()), 1)
    else:
        if t_bound is not None:
            raise ValueError("fp_decode_attention_plain: t_bound needs "
                             "per-row lengths")
        T = length
        hi = torch.full((B, 1), T, dtype=torch.int64, device=dev)
    kk = k[..., :T].float()
    vv = v[:, :, :T].float()
    att = torch.einsum("bhrd,bhdt->bhrt", qg.float(), kk) * (
        1.0 / math.sqrt(D))
    # first admitted position of each row: the left pad, raised by the
    # sliding window
    lo = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    if pad_len is not None:
        lo = torch.clamp(pad_len.to(device=dev, dtype=torch.int64)
                         .reshape(B, 1), min=0)
    if sliding_window:
        lo = torch.maximum(lo, hi - sliding_window)
    pos = torch.arange(T, device=dev)
    valid = (pos >= lo) & (pos < hi)
    if tb is not None:
        valid &= pos < tb
    valid = valid.reshape(B, 1, 1, T)
    att = att.masked_fill(~valid, NEG_INF)
    m = att.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(att - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhrt,bhtd->bhrd", p, vv)
    return out / torch.where(l > 0, l, 1.0)


def fp_decode_attention_kernel(qg, k, v, length, *,
                               sliding_window: Optional[int] = None,
                               pad_len: Optional[torch.Tensor] = None,
                               t_bound: Optional[int] = None
                               ) -> torch.Tensor:
    """Flash-decode over the fp cache; see fp_decode_attention_plain for
    the contract.  On CUDA: qg, k and v contiguous bf16, 16-byte
    aligned, r in (1, 2, 4, 8), D <= 128 and Tmax multiples of 8; a
    host-int length in [1, Tmax], or a (B,) int tensor on the device read
    per row by the kernel (no host sync; the kernel clamps each row into
    [0, Tmax]).  One launch: blocks over (SPLIT-position splits of
    [0, length) or, per row, of [0, t_bound), B*H), the last block of
    each head merging its splits in order.  t_bound is taken with
    per-row lengths only."""
    if not qg.is_cuda:
        return fp_decode_attention_plain(qg, k, v, length,
                                         sliding_window=sliding_window,
                                         pad_len=pad_len, t_bound=t_bound)
    name = "fp_decode_attention_kernel"
    B, H, r, D = qg.shape
    Tmax = k.shape[-1]
    tb = _build.check_t_bound(name, t_bound, Tmax, SPLIT)
    lens = None
    if isinstance(length, torch.Tensor):
        lens = length.to(device=qg.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"{name}: length must be an int or have "
                             f"shape ({B},), got {tuple(lens.shape)}")
        length = 0
    elif t_bound is not None:
        raise ValueError(f"{name}: t_bound needs per-row lengths")
    length = int(length)
    if r not in _ROWS or D > 128 or D % 8 or Tmax % 8 or (
            lens is None and not 1 <= length <= Tmax):
        raise ValueError(f"{name}: unsupported r={r} D={D} "
                         f"length={length} Tmax={Tmax}")
    _build.check_tensors(name, qg.device, {
        "qg": (qg, (B, H, r, D), torch.bfloat16),
        "k": (k, (B, H, D, Tmax), torch.bfloat16),
        "v": (v, (B, H, Tmax, D), torch.bfloat16),
    })
    _build.check_aligned(name, qg, k, v)
    if pad_len is not None:
        pad_len = pad_len.to(device=qg.device, dtype=torch.int32)
        pad_len = pad_len.reshape(B).contiguous()
    out = torch.empty((B, H, r, D), dtype=torch.float32, device=qg.device)
    part_acc, part_ml, tickets = _build.workspace(
        qg.device, B * H, -(-(tb if lens is not None else Tmax) // SPLIT),
        r, D)
    lib = _build.library("fp_decode")
    err = lib.kivi_fp_decode(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(pad_len),
        _build.ptr(lens), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), tickets.data_ptr(), B, H, r, D, Tmax, length,
        tb, int(sliding_window or 0), 1.0 / math.sqrt(D),
        _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
