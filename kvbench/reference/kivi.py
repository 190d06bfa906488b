"""The KIVI cache, written from the method's description and nothing else
(KIVI, arXiv:2402.02750; the configuration's `quant` block):

  * keys are quantized per channel, their statistics taken over groups of
    `group_size` consecutive tokens; values per token, over groups of
    `group_size` consecutive channels;
  * asymmetric: scale = (max - min) / (2**bits - 1), zero point = min,
    code = clamp(round_half_even((x - min) / scale), 0, 2**bits - 1); a
    constant group keeps code 0 and dequantizes to its min; the scale and
    zero point are stored in the configuration's `scale_dtype`;
  * every new token's key and value enter full-precision windows of
    `residual_length` (W) tokens.  A prompt ingested at once keeps
    T mod W keys in the window and quantizes the rest; its quantized value
    count is max(0, T - W) rounded up to `v_flush`.  In decode, a full key
    window is quantized whole, and a full value window quantizes its
    oldest `v_flush` tokens, before the new token is appended.

Quantization blocks start at multiples of W from the first cache slot, so
a token's dequantized key depends only on the aligned group of
`group_size` slots that holds it, and its value on itself.  A query sees
the quantized keys and values below the counts of the moment it is
computed, and the full-precision ones from there to itself.
"""

from __future__ import annotations

import torch


def quantized_values_at_ingest(T: int, W: int, vf: int) -> int:
    """Values quantized when T tokens are ingested at once."""
    return 0 if T <= W else -(-(T - W) // vf) * vf


def flushes(p: int, q0: int, W: int, step: int) -> int:
    """Window flushes done before the token at slot p is appended, in a
    decode that started with q0 quantized tokens: a window flushes when it
    holds W tokens, and each flush quantizes `step` of them."""
    return 0 if p < q0 + W else 1 + (p - q0 - W) // step


class Views:
    """The quantized counts each query sees, slot by slot, for a sequence
    fed as a prefill, then extends, then decode steps (`prefill`,
    `extend`, `decode` in that order of calls).  nkq[p], nvq[p]: the keys
    and values below those slots are read dequantized by the query at
    slot p; 0 for a prefill's queries (exact attention)."""

    def __init__(self, W: int, vf: int):
        self.W, self.vf = W, vf
        self.nkq: list = []
        self.nvq: list = []
        self.kq = self.vq = 0

    @property
    def length(self) -> int:
        return len(self.nkq)

    def _ingest(self, T: int) -> None:
        self.kq = (T // self.W) * self.W
        self.vq = quantized_values_at_ingest(T, self.W, self.vf)

    def prefill(self, T: int) -> "Views":
        assert self.length == 0
        self.nkq += [0] * T
        self.nvq += [0] * T
        self._ingest(T)
        return self

    def extend(self, T1: int) -> "Views":
        self.nkq += [self.kq] * T1
        self.nvq += [self.vq] * T1
        self._ingest(self.length)
        return self

    def decode(self, n: int) -> "Views":
        W, vf, kq0, vq0 = self.W, self.vf, self.kq, self.vq
        for p in range(self.length, self.length + n):
            self.kq = kq0 + W * flushes(p, kq0, W, W)
            self.vq = vq0 + vf * flushes(p, vq0, W, vf)
            self.nkq.append(self.kq)
            self.nvq.append(self.vq)
        return self


def decode_counts(prompt: int, k: int, W: int, vf: int) -> tuple:
    """(quantized keys, window keys, quantized values, window values) seen
    by decode step k (0-based) after a prompt of `prompt` tokens ingested
    at once: the step feeds slot prompt + k and reads prompt + k + 1
    tokens."""
    p = prompt + k
    kq0 = (prompt // W) * W
    vq0 = quantized_values_at_ingest(prompt, W, vf)
    kq = kq0 + W * flushes(p, kq0, W, W)
    vq = vq0 + vf * flushes(p, vq0, W, vf)
    return kq, p + 1 - kq, vq, p + 1 - vq


def _round_trip(x: torch.Tensor, group: int, bits: int,
                scale_dtype: torch.dtype) -> torch.Tensor:
    """Quantize the last axis of x in groups of `group` and dequantize it,
    in f32, with the scale and zero point rounded to scale_dtype."""
    shape = x.shape
    xg = x.float().reshape(*shape[:-1], shape[-1] // group, group)
    lo = xg.amin(dim=-1, keepdim=True)
    hi = xg.amax(dim=-1, keepdim=True)
    scale = (hi - lo) / float((1 << bits) - 1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    code = torch.clamp(torch.round((xg - lo) / safe), 0, (1 << bits) - 1)
    out = (code * scale.to(scale_dtype).float()
           + lo.to(scale_dtype).float())
    return out.reshape(shape)


def dequantized_keys(k: torch.Tensor, group: int, bits: int,
                     scale_dtype: torch.dtype) -> torch.Tensor:
    """k (..., T, D) f32 -> its dequantized copy for the whole groups of
    `group` slots from slot 0 (the partial last group is left as is: no
    query ever reads it quantized)."""
    T = k.shape[-2]
    n = (T // group) * group
    out = k.clone()
    if n:
        kt = k[..., :n, :].transpose(-1, -2)
        out[..., :n, :] = _round_trip(kt, group, bits,
                                      scale_dtype).transpose(-1, -2)
    return out


def dequantized_values(v: torch.Tensor, group: int, bits: int,
                       scale_dtype: torch.dtype) -> torch.Tensor:
    """v (..., T, D) f32 -> its dequantized copy, per token."""
    return _round_trip(v, group, bits, scale_dtype)
