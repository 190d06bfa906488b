"""The K-EXAONE block (`exaone_moe`): sliding layers of a 128-token window
with RoPE, full layers without it over the KIVI cache, QK-norm,
post-norms, a dense first layer, then sparse experts (a sigmoid router
over every expert, the held experts computed, one shared expert).  The
weights are drawn here, the reference is `reference/exaone_moe.py`, the
counts `roofline_exaone_moe.py`.

`kivi_layers(cfg)` names the layers over the KIVI cache, in order: the
driver reads their windows alone, and the reference keeps their keys and
values in the same order.

Random weights route like a trained model only at some scales, and
three are set for that (measured with this family on a copy of the
configuration at hidden 1024, 8 query heads over 1 KV head of 128, a
1,000-token document and 16 rows, 1 token an expert a step on average:
where 64% of the held experts would get a token in a decode step under
uniform routing, the busiest about 3 times the mean by chance):

  * the embedding at 8 (`EMBED_STD`), where the rest is unit normal at
    1 / sqrt(fan-in): a full layer's query over a long random document
    reads near its mean, one vector for every row, which the post-norm
    raises to unit size and adds to every token.  Under a unit embedding
    that shared vector rules the router: 32% of the held experts got a
    token, the busiest 7 times the mean.  At 8 the token keeps the
    residual stream (57%, 3.5 times);
  * router weights at 0.25 / sqrt(hidden) (`ROUTER_GAIN`): logits spread
    by about 2, scores off the sigmoid's flat ends;
  * correction biases at 0.01 (`BIAS_STD`), the spacing of the scores
    near the 8th: a router that ignores the bias chooses otherwise for
    about half the tokens of each layer.

At the cell's own configuration (one H100, 256 rows behind a 32,000-token
document, 16 tokens an expert a decode step on average) the embedding's
scale alone moves the routing so: under a unit embedding 89-92% of the
held experts got a token in a decode step, the busiest 3.8-4.4 times the
mean; at 8, 99.5%, 2.1-2.3 times.

Sharper attention (QK-norm gains of 2) spread the routing as well, but
2-bit keys then flip a query's few keys between the bf16 program and
the f32 reference (a code on the other side of a rounding edge moves a
logit by about 0.5): their logits parted by 3.5 at most, as far as the
fp8 control's.
"""

from __future__ import annotations

import torch

from kvbench import roofline_exaone_moe as roofline  # noqa: F401
from kvbench.reference import exaone_moe as reference  # noqa: F401
from kvbench.weights import _normal_, program_params  # noqa: F401


def config(conf: dict) -> tuple:
    from kivi_tpu_torch.config import ExaoneMoEConfig, QuantConfig
    model = dict(conf["model"], layer_types=tuple(conf["model"]["layer_types"]),
                 experts_here=tuple(conf["model"]["experts_here"]))
    return ExaoneMoEConfig(**model), QuantConfig(**conf["quant"])


def kivi_layers(cfg) -> list:
    return [i for i, t in enumerate(cfg.layer_types) if t == "full"]


def _shapes(cfg) -> dict:
    """Every matrix kind: (layers it is in, shape a layer)."""
    Hd, D = cfg.hidden_size, cfg.head_dim
    I, Ie = cfg.intermediate_size, cfg.moe_intermediate_size
    Is, E = Ie * cfg.num_shared_experts, len(cfg.experts_here)
    L, dense = cfg.num_layers, cfg.first_k_dense
    sparse = range(dense, L)
    out = {"wq": (range(L), (Hd, cfg.num_heads * D)),
           "wk": (range(L), (Hd, cfg.num_kv_heads * D)),
           "wv": (range(L), (Hd, cfg.num_kv_heads * D)),
           "wo": (range(L), (cfg.num_heads * D, Hd)),
           "wg": (range(dense), (Hd, I)), "wu": (range(dense), (Hd, I)),
           "wd": (range(dense), (I, Hd)),
           "router": (sparse, (Hd, cfg.num_experts)),
           "we_g": (sparse, (E, Hd, Ie)), "we_u": (sparse, (E, Hd, Ie)),
           "we_d": (sparse, (E, Ie, Hd))}
    if Is:
        out.update(ws_g=(sparse, (Hd, Is)), ws_u=(sparse, (Hd, Is)),
                   ws_d=(sparse, (Is, Hd)))
    return out


ROUTER_GAIN, BIAS_STD, EMBED_STD = 0.25, 0.01, 8.0


def _scale(cfg, kind: str) -> float:
    fan_in = {"wd": cfg.intermediate_size, "we_d": cfg.moe_intermediate_size,
              "ws_d": cfg.moe_intermediate_size * cfg.num_shared_experts}
    gain = ROUTER_GAIN if kind == "router" else 1.0
    return gain * fan_in.get(kind, cfg.hidden_size) ** -0.5


def make_params(cfg, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of `seed`, each kind of matrix one tensor over the
    layers that hold it (bf16), the routers' correction biases one f32
    tensor, the norms at one; a list of per-layer dicts of views, in the
    port's layout (models/modeling.py: `_hybrid_layer_params`)."""
    L, Hd, V, D = (cfg.num_layers, cfg.hidden_size, cfg.vocab_size,
                   cfg.head_dim)
    kinds = _shapes(cfg)
    stacks = {k: torch.empty((len(rng), *s), dtype=dtype, device=device)
              for k, (rng, s) in kinds.items()}
    sparse = L - cfg.first_k_dense
    bias = torch.empty((sparse, cfg.num_experts), dtype=torch.float32,
                       device=device)
    norms = torch.ones((L, 2 * Hd + 2 * D), dtype=dtype, device=device)
    layers = []
    for i in range(L):
        lp = {k: stacks[k][i - rng.start] for k, (rng, _) in kinds.items()
              if i in rng}
        lp.update(ln_post_attn=norms[i, :Hd], ln_post_mlp=norms[i, Hd:2 * Hd],
                  q_norm=norms[i, 2 * Hd:2 * Hd + D],
                  k_norm=norms[i, 2 * Hd + D:])
        if i >= cfg.first_k_dense:
            lp["router_bias"] = bias[i - cfg.first_k_dense]
        layers.append(lp)
    params = {"embed": torch.empty((V, Hd), dtype=dtype, device=device),
              "lm_head": torch.empty((Hd, V), dtype=dtype, device=device),
              "ln_f": torch.ones(Hd, dtype=dtype, device=device),
              "layers": layers, "_stacks": stacks, "_bias": bias}
    refill(params, cfg, seed)
    return params


def refill(params: dict, cfg, seed: int) -> None:
    """Draw the weights of `seed` into params' tensors in place: normal at
    1 / sqrt(fan-in) (the routers at ROUTER_GAIN times that), the
    embedding at EMBED_STD, each correction bias at BIAS_STD."""
    dev = params["embed"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    for k, t in params["_stacks"].items():
        _normal_(t, gen, _scale(cfg, k))
    _normal_(params["embed"], gen, EMBED_STD)
    _normal_(params["lm_head"], gen, cfg.hidden_size ** -0.5)
    _normal_(params["_bias"], gen, BIAS_STD)
