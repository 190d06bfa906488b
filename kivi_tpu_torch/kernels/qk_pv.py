"""Split dequant matmuls over the packed KIVI stores: wrappers of
`csrc/qk_pv.cu` (ports of `qk_dequant_matmul` and `pv_dequant_matmul` in
`kivi_tpu/kernels/qk_pv.py`) and their plain versions.

They are the two halves of split decode attention (flash-decoding over
T, `core.attention._decode_attention_split`): QK writes the logits of
the quantized key store, torch takes the softmax over them and the fp
window, and PV sums the probabilities against the quantized value store.
Each kernel spreads the cache over SPLIT-position splits, one block per
(split, row, KV head) in one launch, so a batch-1 decode fills the card;
PV's last block of each head adds the splits' partials in order.

Signatures and layouts are the JAX package's: qg (B, H, r, D), codes
(B, H, Dw, T), K scales (B, H, T//gs, D) rows, V scales (B, H, D//gs, T),
and `n_quant` a host int (default T).  Both compute in f32 from their
bf16 or f32 inputs; the JAX kernels' default (`compute_dtype=bf16`)
rounds the dequantized tile and p to bf16 first.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build

NEG_INF = -1e30
_ROWS = (1, 2, 4, 8)  # query rows per KV head the kernels are built for
SPLIT = 256           # positions per block of both kernels (csrc kdec::S)


def split_plan(n_quant: int) -> int:
    """PV's blocks per (row, KV head): SPLIT-position splits of [0,
    n_quant), at least one (n_quant 0 writes zeros).  QK runs one block
    per split of all of T, dead splits writing NEG_INF."""
    return max(1, -(-int(n_quant) // SPLIT))


def qk_dequant_matmul_plain(qg, k_codes, k_scale, k_mn, group_size: int,
                            bits: int,
                            n_quant: Optional[int] = None) -> torch.Tensor:
    """att = qg @ dequant(K): (B,H,r,D) x (B,H,Dw,T) -> (B,H,r,T) f32,
    NEG_INF at positions >= n_quant."""
    T = k_codes.shape[-1]
    nq = T if n_quant is None else int(n_quant)
    k_deq = Q.dequantize_k(k_codes, k_scale, k_mn, group_size, bits)
    att = torch.einsum("bhrd,bhdt->bhrt", qg.float(), k_deq)
    return att.masked_fill(torch.arange(T, device=qg.device) >= nq, NEG_INF)


def pv_dequant_matmul_plain(p, v_codes, v_scale, v_mn, group_size: int,
                            bits: int,
                            n_quant: Optional[int] = None) -> torch.Tensor:
    """out = p @ dequant(V): (B,H,r,T) x (B,H,Dw,T) -> (B,H,r,D) f32 over
    the positions < n_quant (p must be zero beyond them: the JAX kernel
    skips only whole tiles past n_quant)."""
    T = v_codes.shape[-1]
    nq = T if n_quant is None else int(n_quant)
    if nq == 0:
        B, H, r, _ = p.shape
        D = v_codes.shape[2] * (32 // bits)
        return torch.zeros((B, H, r, D), dtype=torch.float32,
                           device=p.device)
    v_deq = Q.dequantize_v(v_codes[..., :nq], v_scale[..., :nq],
                           v_mn[..., :nq], group_size, bits)
    return torch.einsum("bhrt,bhtd->bhrd", p[..., :nq].float(), v_deq)


def _check_cuda(name, x, x_shape, x_dtype, codes, scale, mn, scale_shape,
                D, T, group_size, bits):
    """Raise unless the CUDA kernel takes these inputs (x: qg or p)."""
    B, H, r = x_shape[:3]
    gs, sdt = group_size, scale.dtype
    if bits not in (2, 4, 8):
        raise ValueError(f"{name}: bits must be 2, 4 or 8")
    if (r not in _ROWS or D > 128 or D % 4 or D % (32 // bits) or gs < 1
            or D % gs or 128 % gs or T % 4):
        raise ValueError(f"{name}: unsupported r={r} D={D} gs={gs} T={T}")
    if sdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: scales must be bf16 or f32, got {sdt}")
    _build.check_tensors(name, x.device, {
        "input": (x, x_shape, x_dtype),
        "codes": (codes, (B, H, Q.num_words(D, bits), T), torch.int32),
        "scale": (scale, scale_shape, sdt),
        "mn": (mn, scale_shape, sdt),
    })
    # code and p rows are copied in 16-byte pieces (T % 4 == 0 above),
    # scale rows and columns in 16- or 8-byte ones
    _build.check_aligned(name, x, codes, scale, mn)


def qk_dequant_matmul(qg, k_codes, k_scale, k_mn, group_size: int,
                      bits: int, n_quant: Optional[int] = None
                      ) -> torch.Tensor:
    """att = qg @ dequant(K) -> (B,H,r,T) f32, NEG_INF at positions
    >= n_quant; splits at or past n_quant never read the store.  On CUDA:
    qg bf16, scales bf16 or f32, r in (1, 2, 4, 8), D <= 128,
    128 % group_size == 0, T a multiple of 4 and of group_size, the
    arrays 16-byte aligned.  One launch."""
    if not qg.is_cuda:
        return qk_dequant_matmul_plain(qg, k_codes, k_scale, k_mn,
                                       group_size, bits, n_quant)
    name = "qk_dequant_matmul"
    B, H, r, D = qg.shape
    T, gs = k_codes.shape[-1], group_size
    if T % gs:
        raise ValueError(f"{name}: T={T} is not a multiple of gs={gs}")
    _check_cuda(name, qg, (B, H, r, D), torch.bfloat16, k_codes, k_scale,
                k_mn, (B, H, T // gs, D), D, T, gs, bits)
    nq = T if n_quant is None else min(max(int(n_quant), 0), T)
    out = torch.empty((B, H, r, T), dtype=torch.float32, device=qg.device)
    err = _build.library("qk_pv").kivi_qk_dequant(
        qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        k_mn.data_ptr(), out.data_ptr(), B, H, r, D, T, gs, bits, nq,
        int(k_scale.dtype == torch.float32), SPLIT,
        _build.stream_handle(qg.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def pv_dequant_matmul(p, v_codes, v_scale, v_mn, group_size: int,
                      bits: int, n_quant: Optional[int] = None
                      ) -> torch.Tensor:
    """out = p @ dequant(V) over positions < n_quant -> (B,H,r,D) f32.
    One launch: a block per live SPLIT-position split writes its partial
    sum into the workspace, the last block of each head adds them in
    split order (no atomics on the data: the same inputs give the same
    bits).  On CUDA: p f32, scales bf16 or f32, r in (1, 2, 4, 8),
    D <= 128, 128 % group_size == 0, T a multiple of 4, the arrays
    16-byte aligned."""
    if not p.is_cuda:
        return pv_dequant_matmul_plain(p, v_codes, v_scale, v_mn,
                                       group_size, bits, n_quant)
    name = "pv_dequant_matmul"
    B, H, r, T = p.shape
    gs = group_size
    D = v_codes.shape[2] * (32 // bits)
    _check_cuda(name, p, (B, H, r, T), torch.float32, v_codes, v_scale,
                v_mn, (B, H, D // gs, T), D, T, gs, bits)
    nq = T if n_quant is None else min(max(int(n_quant), 0), T)
    part, _, tickets = _build.workspace(p.device, B * H, split_plan(T), r, D)
    out = torch.empty((B, H, r, D), dtype=torch.float32, device=p.device)
    err = _build.library("qk_pv").kivi_pv_dequant(
        p.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), B, H, r, D, T, gs, bits, nq,
        int(v_scale.dtype == torch.float32), SPLIT, split_plan(nq),
        _build.stream_handle(p.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
