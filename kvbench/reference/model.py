"""The plain reference: the decoder in f32 (TF32 off), layer by layer, over
the KIVI cache of `reference/kivi.py`.  It imports torch and the
benchmark's own modules only.

The model: token embedding; per layer x += Wo(attn(RMSNorm(x))) and
x += Wd(silu(Wg h) * Wu h) with h = RMSNorm(x); a final RMSNorm and an
untied head.  RMSNorm: x / sqrt(mean(x^2) + eps) * w.  RoPE on queries
and keys, half-split (rotate_half) at the true token position, theta from
the configuration, no scaling.  Grouped heads: query head h reads KV head
h // (heads / kv_heads).  Attention softmax(q k / sqrt(D)) over the keys
at or before the query.  Weights are the benchmark's own tensors, in the
(in, out) layout, read in bf16 and computed in f32.

A `Group` is one cached sequence as the program's cache holds it: `pad`
empty slots (zero keys and values, never attended), a prompt computed at
once (exact attention), then `rows` continuations of it, each a row of
the program's batch, whose queries see the KIVI cache slot by slot
(`Views`).  `logits` returns, for each row, the logits at the prompt's
last token and at every continuation token.

`low=True` is the control: every matrix product takes its operands
rounded to float8 e4m3 (weights per output channel, activations per
token, each scaled to the format's largest value) and accumulates in
f32, as an fp8 GEMM would; everything else is as above.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from kvbench.reference import kivi
# the cache policy that the drivers count with
from kvbench.reference.kivi import (decode_counts,  # noqa: F401
                                    quantized_values_at_ingest)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
FP8_MAX = 448.0
QUERY_BLOCK = 512


@dataclasses.dataclass
class Group:
    prompt: torch.Tensor      # (T0,) token ids
    pad: int                  # empty slots before the prompt
    rows: torch.Tensor        # (R, M) token ids after the prompt
    nkq: list                 # per continuation slot, quantized keys seen
    nvq: list                 # per continuation slot, quantized values seen


def exact_matmuls() -> None:
    """f32 products in f32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Mat:
    """x @ W in f32, or through fp8 operands for the control."""

    def __init__(self, low: bool):
        self.low = low

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.low else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x, -1) if self.low else x) @ w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, D) at positions pos (T,)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _heads(x, n, D):
    """(..., T, n*D) -> (..., n, T, D)."""
    return x.reshape(*x.shape[:-1], n, D).transpose(-2, -3)


def _prompt_attention(q, k, v, r):
    """Exact causal attention: q (Hq, T, D), k, v (Hkv, T, D)."""
    Hkv, T, D = k.shape
    out = torch.empty_like(q)
    qg = q.reshape(Hkv, r, T, D)
    og = out.reshape(Hkv, r, T, D)
    for s in range(0, T, QUERY_BLOCK):
        e = min(T, s + QUERY_BLOCK)
        sc = torch.einsum("hrqd,hkd->hrqk", qg[:, :, s:e], k[:, :e])
        sc = sc / math.sqrt(D)
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(e, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, -math.inf)
        og[:, :, s:e] = torch.einsum("hrqk,hkd->hrqd", sc.softmax(-1),
                                     v[:, :e])
    return out


def _row_attention(q, K, Kq, V, Vq, pad, first, nkq, nvq, r):
    """One row's continuation queries q (Hq, M, D) at slots first ..
    first + M - 1 over its cache K, V (Hkv, C, D) and their dequantized
    copies Kq, Vq: slot j is read dequantized where j < nkq (keys) or
    j < nvq (values) of the query's slot, and attended from `pad` to the
    query's own slot."""
    Hkv, C, D = K.shape
    M = q.shape[1]
    dev = q.device
    qg = q.reshape(Hkv, r, M, D)
    j = torch.arange(C, device=dev)[None, :]
    slot = first + torch.arange(M, device=dev)[:, None]
    use_kq = j < torch.as_tensor(nkq, device=dev)[:, None]
    use_vq = j < torch.as_tensor(nvq, device=dev)[:, None]
    sc = torch.where(use_kq, torch.einsum("hrmd,hcd->hrmc", qg, Kq),
                     torch.einsum("hrmd,hcd->hrmc", qg, K)) / math.sqrt(D)
    sc = sc.masked_fill((j > slot) | (j < pad), -math.inf)
    p = sc.softmax(-1)
    out = (torch.einsum("hrmc,hcd->hrmd", p * use_vq, Vq)
           + torch.einsum("hrmc,hcd->hrmd", p * ~use_vq, V))
    return out.reshape(Hkv * r, M, D)


def logits(params: dict, cfg, qcfg, groups: list, low: bool = False,
           kv_of=None) -> list:
    """For each group, (R, 1 + M, vocab) f32 logits: at the prompt's last
    token, then at each continuation token of each row.  kv_of: indices
    of groups whose continuation keys (after RoPE) and values are kept
    too, every layer's (R, Hkv, M, D); given kv_of, returns (logits,
    {index: (keys, values)})."""
    if cfg.rope_scaling is not None or cfg.sliding_window is not None:
        raise ValueError("the reference has no RoPE scaling and no sliding "
                         "window")
    exact_matmuls()
    mat = _Mat(low)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r, eps, theta = Hq // Hkv, cfg.rms_norm_eps, cfg.rope_theta
    gs, sdt = qcfg.group_size, _DTYPES[qcfg.scale_dtype]
    embed = params["embed"]
    kept = {i: ([], []) for i in (kv_of or ())}
    state = []
    for g in groups:
        dev = embed.device
        prompt, rows = g.prompt.to(dev), g.rows.to(dev)
        state.append((embed[prompt].float(),
                      embed[rows].float() if rows.numel() else None))
    for lp in params["layers"]:
        w = {n: mat.weight(lp[n]) for n in ("wq", "wk", "wv", "wo", "wg",
                                            "wu", "wd")}
        for i, g in enumerate(groups):
            xp, xr = state[i]
            T0 = xp.shape[0]
            pos = torch.arange(T0, device=xp.device)
            h = _rms(xp, lp["ln_attn"], eps)
            q = _rope(_heads(mat(h, w["wq"]), Hq, D), pos, theta)
            k = _rope(_heads(mat(h, w["wk"]), Hkv, D), pos, theta)
            v = _heads(mat(h, w["wv"]), Hkv, D)
            o = _prompt_attention(q, k, v, r)
            xp = xp + mat(o.transpose(0, 1).reshape(T0, Hq * D), w["wo"])
            xp = xp + _mlp(mat, _rms(xp, lp["ln_mlp"], eps), w)
            if xr is not None:
                R, M, _ = xr.shape
                rpos = T0 + torch.arange(M, device=xr.device)
                hr = _rms(xr, lp["ln_attn"], eps)
                qr = _rope(_heads(mat(hr, w["wq"]), Hq, D), rpos, theta)
                kr = _rope(_heads(mat(hr, w["wk"]), Hkv, D), rpos, theta)
                vr = _heads(mat(hr, w["wv"]), Hkv, D)
                if i in kept:
                    kept[i][0].append(kr)
                    kept[i][1].append(vr)
                zero = k.new_zeros(Hkv, g.pad, D)
                outs = []
                for b in range(R):
                    K = torch.cat([zero, k, kr[b]], dim=1)
                    V = torch.cat([zero, v, vr[b]], dim=1)
                    Kq = kivi.dequantized_keys(K, gs, qcfg.k_bits, sdt)
                    Vq = kivi.dequantized_values(V, gs, qcfg.v_bits, sdt)
                    outs.append(_row_attention(
                        qr[b], K, Kq, V, Vq, g.pad, g.pad + T0, g.nkq,
                        g.nvq, r))
                o = torch.stack(outs).transpose(1, 2).reshape(R, M, Hq * D)
                xr = xr + mat(o, w["wo"])
                xr = xr + _mlp(mat, _rms(xr, lp["ln_mlp"], eps), w)
            state[i] = (xp, xr)
    head = mat.weight(params["lm_head"])
    out = []
    for xp, xr in state:
        last = xp[-1:]
        R = 1 if xr is None else xr.shape[0]
        x = last.expand(R, 1, -1)
        if xr is not None:
            x = torch.cat([x, xr], dim=1)
        out.append(mat(_rms(x, params["ln_f"], eps), head))
    return (out, kept) if kv_of is not None else out


def _mlp(mat, h, w):
    return mat(torch.nn.functional.silu(mat(h, w["wg"])) * mat(h, w["wu"]),
               w["wd"])


def group(prompt, pad: int, rows, W: int, vf: int, extend: int = 0
          ) -> Group:
    """A Group whose continuation is `extend` tokens ingested at once
    after the prompt (0: none), then decode steps for the rest of each
    row.  rows: (R, M) token ids."""
    rows = torch.as_tensor(rows, dtype=torch.long)
    M = rows.shape[1]
    views = kivi.Views(W, vf).prefill(pad + len(prompt))
    if extend:
        views.extend(extend)
    views.decode(M - extend)
    first = pad + len(prompt)
    return Group(prompt=torch.as_tensor(prompt), pad=pad, rows=rows,
                 nkq=views.nkq[first:], nvq=views.nvq[first:])


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each chosen token's reference logit lies below the
    reference's best: ref (N, V), tokens (N,) -> (N,)."""
    chosen = ref.gather(1, tokens.to(ref.device).long()[:, None])[:, 0]
    return ref.amax(1) - chosen


def window_gap(g: Group, ref_kv: tuple, prog: dict) -> tuple:
    """(layers off, widest gap) between the caches a program's decode
    steps left after the group's last token and the reference's.  Layers
    off: the layers whose counts (quantized keys, window keys, quantized
    values, window values) differ from those the KIVI policy gives (a
    step that skipped its append or a flush).  Widest gap: over the
    other layers, every row and every window token that the continuation
    fed, |prog - ref| / |ref| of its keys and of its values over one
    token's heads and channels.  prog: {"counts": per layer, "k", "v":
    per layer (R, Hkv, n, D) windows}; without "counts", "k" and "v"
    hold every continuation token (R, Hkv, M, D), as the control's
    reference gives them, and no layer is off."""
    keys, values = ref_kv
    start = g.pad + len(g.prompt)
    total = start + g.rows.shape[1]
    kq, vq = g.nkq[-1], g.nvq[-1]
    want = (kq, total - kq, vq, total - vq)
    counts = prog.get("counts")
    off_layers, worst = 0, 0.0
    for layer in range(len(keys)):
        if counts is not None and tuple(int(c) for c in counts[layer]) \
                != want:
            off_layers += 1
            continue
        for ref, win, q0 in ((keys[layer], prog["k"][layer], kq),
                             (values[layer], prog["v"][layer], vq)):
            first = max(start, q0)
            if first >= total:
                continue
            r = ref[:, :, first - start:]
            off = first - (q0 if counts is not None else start)
            p = win[:, :, off:off + r.shape[2]].to(r.device, torch.float32)
            num = (p - r).square().sum((1, 3)).sqrt()
            den = r.square().sum((1, 3)).sqrt().clamp(min=1e-30)
            worst = max(worst, float((num / den).max()))
    return off_layers, worst


