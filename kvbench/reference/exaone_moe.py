"""The plain reference of the K-EXAONE block (`exaone_moe`): the decoder in
f32 (TF32 off), layer by layer, casting each layer's bf16 weights to f32
as it uses them.  It imports torch and the benchmark's own modules only.

The model (`transformers`' `exaone4` attention and norms, DeepSeek-V3's
router): token embedding; per layer

    h = attn(x);  x = x + RMSNorm_post_attn(h)
    h = mlp(x);   x = x + RMSNorm_post_mlp(h)

with no norm ahead of either; a final RMSNorm and an untied head.
Attention: q = Wq x, k = Wk x, v = Wv x per head, then a per-head RMSNorm
of width head_dim on q and on k (`q_norm`, `k_norm`); RoPE (half-split,
theta from the configuration, no scaling) on the sliding layers only.  A
sliding layer's query at position t attends keys p with
t - window < p <= t, exactly, in f32; a full layer's attends every p <= t
over the reference's own KIVI cache (`reference/kivi.py`), as
`reference/model.py` computes it.  Grouped heads: query head h reads KV
head h // (heads / kv_heads).  The MLP of the first `first_k_dense`
layers is SwiGLU, Wd(silu(Wg h) * Wu h); every later layer's:

    s = sigmoid(h Wr)                        (f32, all num_experts)
    chosen = the experts_per_tok largest of s + router_bias
    w = s[chosen] / sum(s[chosen]) * routed_scaling_factor
    out = sum over chosen e held here of w_e SwiGLU_e(h)
          + the shared experts' SwiGLU(h)

Departures from the published model, each also in the configuration's
file:
  * the multi-token-prediction layer is not held (it serves
    self-speculation only);
  * the router's equations are `assumed`: the configuration's routing
    keys (`scoring_func: sigmoid`, `n_group 1`, `topk_group 1`,
    `norm_topk_prob`, `routed_scaling_factor`) are DeepSeek-V3's, whose
    `noaux_tc` choice with one group is the above;
  * only the held experts (`experts_here`) are computed: what the others
    would add is left out, in the program and here alike, as one chip of
    the expert-parallel deployment computes it.

Left pads are not taken (the program's rings hold none).  `low=True` is
the control: every matrix product, the router's included, takes its
operands rounded to float8 e4m3, as `reference/model.py` says.
"""

from __future__ import annotations

import math

import torch

from kvbench.reference import kivi
# the rest of the interface is the dense block's, unchanged: a Group and
# its KIVI views, the gaps, the window comparison, the cache policy
from kvbench.reference.model import (Group, _heads, _Mat,  # noqa: F401
                                     _rms, _rope, _row_attention,
                                     decode_counts, exact_matmuls, gaps,
                                     group, quantized_values_at_ingest,
                                     window_gap)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
QUERY_BLOCK = 256      # prompt queries a block: (heads, 256, T) f32 scores
ROW_BLOCK = 64         # continuation queries a block over a row's cache


def _prompt_attention(q, k, v, r, window):
    """Exact causal attention, q (Hq, T, D), k, v (Hkv, T, D); window:
    keys p > t - window only (None: all p <= t)."""
    Hkv, T, D = k.shape
    out = torch.empty_like(q)
    qg = q.reshape(Hkv, r, T, D)
    og = out.reshape(Hkv, r, T, D)
    for s in range(0, T, QUERY_BLOCK):
        e = min(T, s + QUERY_BLOCK)
        lo = 0 if window is None else max(0, s - window + 1)
        sc = torch.einsum("hrqd,hkd->hrqk", qg[:, :, s:e], k[:, lo:e])
        sc = sc / math.sqrt(D)
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(lo, e, device=q.device)[None, :]
        mask = kpos > qpos
        if window is not None:
            mask |= kpos <= qpos - window
        sc = sc.masked_fill(mask, -math.inf)
        og[:, :, s:e] = torch.einsum("hrqk,hkd->hrqd", sc.softmax(-1),
                                     v[:, lo:e])
    return out


def _window_rows(q, k, v, kr, vr, r, window):
    """The continuation queries q (R, Hq, M, D) at positions T0 .. T0 +
    M - 1 of rows whose prompt keys and values are k, v (Hkv, T0, D) and
    own ones kr, vr (R, Hkv, M, D), each over its exact window."""
    R, Hq, M, D = q.shape
    Hkv, T0, _ = k.shape
    lo = max(0, T0 - window + 1)
    kpos = torch.arange(lo, T0 + M, device=q.device)[None, :]
    qpos = T0 + torch.arange(M, device=q.device)[:, None]
    mask = (kpos > qpos) | (kpos <= qpos - window)
    outs = []
    for b in range(R):
        K = torch.cat([k[:, lo:], kr[b]], dim=1)
        V = torch.cat([v[:, lo:], vr[b]], dim=1)
        sc = torch.einsum("hrmd,hcd->hrmc", q[b].reshape(Hkv, r, M, D),
                          K) / math.sqrt(D)
        p = sc.masked_fill(mask, -math.inf).softmax(-1)
        outs.append(torch.einsum("hrmc,hcd->hrmd", p, V).reshape(Hq, M, D))
    return torch.stack(outs)


def _kivi_rows(q, k, v, kr, vr, r, g, qcfg, sdt):
    """The continuation queries q (R, Hq, M, D) over the prompt's and
    their own keys and values on the reference's KIVI cache (the views
    of group g), in blocks of ROW_BLOCK queries."""
    R, Hq, M, D = q.shape
    Hkv = k.shape[0]
    first = g.pad + k.shape[1]
    outs = []
    for b in range(R):
        K = torch.cat([k, kr[b]], dim=1)
        V = torch.cat([v, vr[b]], dim=1)
        Kq = kivi.dequantized_keys(K, qcfg.group_size, qcfg.k_bits, sdt)
        Vq = kivi.dequantized_values(V, qcfg.group_size, qcfg.v_bits, sdt)
        o = torch.empty(Hq, M, D, device=q.device)
        for s in range(0, M, ROW_BLOCK):
            e = min(M, s + ROW_BLOCK)
            o[:, s:e] = _row_attention(
                q[b][:, s:e], K[:, :first + e], Kq[:, :first + e],
                V[:, :first + e], Vq[:, :first + e], g.pad, first + s,
                g.nkq[s:e], g.nvq[s:e], r)
        outs.append(o)
    return torch.stack(outs)


def _swiglu(mat, h, wg, wu, wd):
    return mat(torch.nn.functional.silu(mat(h, wg)) * mat(h, wu), wd)


def moe(mat, h, lp, cfg):
    """The expert layer over h (T, Hd) f32: the held experts' part and the
    shared experts (module docstring)."""
    s = torch.sigmoid(mat(h, mat.weight(lp["router"])))
    idx = torch.topk(s + lp["router_bias"].float(), cfg.experts_per_tok,
                     dim=-1).indices
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg.routed_scaling_factor
    out = torch.zeros_like(h)
    for j, e in enumerate(cfg.experts_here):
        sel = idx == e
        rows = sel.any(1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        we = (w * sel).sum(1)[rows]
        y = _swiglu(mat, h[rows], mat.weight(lp["we_g"][j]),
                    mat.weight(lp["we_u"][j]), mat.weight(lp["we_d"][j]))
        out.index_add_(0, rows, we[:, None] * y)
    if cfg.num_shared_experts:
        out = out + _swiglu(mat, h, mat.weight(lp["ws_g"]),
                            mat.weight(lp["ws_u"]), mat.weight(lp["ws_d"]))
    return out


def _mlp(mat, h, lp, cfg, layer):
    if layer < cfg.first_k_dense:
        return _swiglu(mat, h, mat.weight(lp["wg"]), mat.weight(lp["wu"]),
                       mat.weight(lp["wd"]))
    return moe(mat, h.reshape(-1, h.shape[-1]), lp, cfg).reshape(h.shape)


def logits(params: dict, cfg, qcfg, groups: list, low: bool = False,
           kv_of=None) -> list:
    """For each group, (R, 1 + M, vocab) f32 logits: at the prompt's last
    token, then at each continuation token of each row.  kv_of: indices
    of groups whose continuation keys (after RoPE where the layer has it)
    and values are kept too, each full layer's (R, Hkv, M, D), in the
    order of the full layers; given kv_of, returns (logits, {index:
    (keys, values)})."""
    if cfg.rope_scaling is not None:
        raise ValueError("the reference has no RoPE scaling")
    if any(g.pad for g in groups):
        raise ValueError("the K-EXAONE reference takes no left pads")
    exact_matmuls()
    mat = _Mat(low)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r, eps, theta = Hq // Hkv, cfg.rms_norm_eps, cfg.rope_theta
    sdt = _DTYPES[qcfg.scale_dtype]
    embed = params["embed"]
    kept = {i: ([], []) for i in (kv_of or ())}
    state = []
    for g in groups:
        dev = embed.device
        prompt, rows = g.prompt.to(dev), g.rows.to(dev)
        state.append((embed[prompt].float(),
                      embed[rows].float() if rows.numel() else None))
    for layer, lp in enumerate(params["layers"]):
        sliding = cfg.layer_types[layer] == "sliding"
        window = cfg.sliding_window if sliding else None
        w = {n: mat.weight(lp[n]) for n in ("wq", "wk", "wv", "wo")}

        def qkv(x, pos):
            q = _rms(_heads(mat(x, w["wq"]), Hq, D), lp["q_norm"], eps)
            k = _rms(_heads(mat(x, w["wk"]), Hkv, D), lp["k_norm"], eps)
            if sliding:
                q, k = _rope(q, pos, theta), _rope(k, pos, theta)
            return q, k, _heads(mat(x, w["wv"]), Hkv, D)

        def block(x, o):
            x = x + _rms(mat(o, w["wo"]), lp["ln_post_attn"], eps)
            return x + _rms(_mlp(mat, x, lp, cfg, layer), lp["ln_post_mlp"],
                            eps)

        for i, g in enumerate(groups):
            xp, xr = state[i]
            T0 = xp.shape[0]
            q, k, v = qkv(xp, torch.arange(T0, device=xp.device))
            o = _prompt_attention(q, k, v, r, window)
            xp = block(xp, o.transpose(0, 1).reshape(T0, Hq * D))
            if xr is not None:
                R, M, _ = xr.shape
                qr, kr, vr = qkv(xr, T0 + torch.arange(M, device=xr.device))
                if sliding:
                    o = _window_rows(qr, k, v, kr, vr, r, window)
                else:
                    if i in kept:
                        kept[i][0].append(kr)
                        kept[i][1].append(vr)
                    o = _kivi_rows(qr, k, v, kr, vr, r, g, qcfg, sdt)
                xr = block(xr, o.transpose(1, 2).reshape(R, M, Hq * D))
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
