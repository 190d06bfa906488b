"""Operations and bytes of the K-EXAONE block (`families/exaone_moe.py`),
counted as `roofline.py` counts the dense block, with what this block
changes:

| Function | Operations | Bytes | Why |
|---|---|---|---|
| `layer_params` | - | - | the weight parameters every token multiplies through, summed over the layers: attention, the dense MLP, the routers, the shared experts (not the routed experts) |
| `weight_bytes` | - | those, the norms, the routers' f32 biases, every held routed expert, the final norm and the head, once | a forward that hits every held expert reads each weight once |
| `forward` | 2 x `layer_params` per token; 2 x one expert's parameters per (token, held expert) pair, their expected count tokens x experts_per_tok x held / num_experts; 2 Hd V per logit row; 4 Hq D per query and key it sees, every key below it in a full layer, the window's in a sliding layer | the weights but the routed experts; in each sparse layer the weights of the held experts its tokens are expected to hit, held x (1 - (1 - experts_per_tok / num_experts) ** tokens); the history's `kivi_bytes` in the full layers (a shared prefix once); in the sliding layers the ring's min(window, length) keys and values a row in bf16; the new tokens' keys and values written (in a ring only the last window of them); the embedding rows; the f32 logits | routing is drawn from random weights and is near uniform: the expectation is the work these inputs need |
| `decode_attention`, `decode_layers` | `roofline.decode_attention` (at the block's r = 8) | the same | row 6 runs in the full layers alone, over their KIVI cache |
| `expert_gemm(cfg, counts)` | 2 x 3 Hd I_expert per pair | the weights of each held expert with a token, each pair's input row and output row in bf16 | one call of the grouped expert GEMM (both launches) from the tokens on each held expert; the intermediate between the launches is not the inputs' work |

Each returns (operations, bytes), the order `roofline.bound_s` takes.
"""

from __future__ import annotations

from kvbench.roofline import BF16, decode_attention, kivi_bytes  # noqa: F401


def _full(cfg) -> int:
    return cfg.layer_types.count("full")


def _sparse(cfg) -> int:
    return cfg.num_layers - cfg.first_k_dense


def _expert(cfg) -> int:
    """Parameters of one routed (or shared) expert."""
    return 3 * cfg.hidden_size * cfg.moe_intermediate_size


def _attention(cfg) -> int:
    Hd, D = cfg.hidden_size, cfg.head_dim
    return Hd * cfg.num_heads * D * 2 + Hd * cfg.num_kv_heads * D * 2


def layer_params(cfg) -> int:
    """The parameters every token multiplies through, all layers."""
    Hd = cfg.hidden_size
    return (cfg.num_layers * _attention(cfg)
            + cfg.first_k_dense * 3 * Hd * cfg.intermediate_size
            + _sparse(cfg) * (Hd * cfg.num_experts
                              + cfg.num_shared_experts * _expert(cfg)))


def _held_bytes(cfg) -> int:
    return BF16 * len(cfg.experts_here) * _expert(cfg)


def _norm_bytes(cfg) -> int:
    return BF16 * cfg.num_layers * (2 * cfg.hidden_size + 2 * cfg.head_dim)


def weight_bytes(cfg) -> int:
    Hd = cfg.hidden_size
    return (BF16 * (layer_params(cfg) + Hd + Hd * cfg.vocab_size)
            + _norm_bytes(cfg) + 4 * _sparse(cfg) * cfg.num_experts
            + _sparse(cfg) * _held_bytes(cfg))


def decode_layers(cfg) -> int:
    """The layers whose decode attention runs row 6: the full ones."""
    return _full(cfg)


def _window_seen(h: int, n: int, W: int) -> int:
    """Keys the tokens at positions h .. h + n - 1 see in a window of W
    (each its own and up to W - 1 before it)."""
    below = max(0, min(h + n, W) - h)
    return below * h + below * (below + 1) // 2 + (n - below) * W


def forward(cfg, qcfg, rows: int, new: int, history=(), shared=(0, 0),
            logit_rows: int = 0, causal_new: bool = True) -> tuple:
    """(operations, bytes) of one forward over `rows` rows of `new` new
    tokens each, as `roofline.forward` takes them: history per row
    (nkq, nkw, nvq, nvw) of the full layers' KIVI cache (every layer of
    the block has seen the same positions); a decode step (new=1,
    causal_new=False) has its token in that history already."""
    Hq, Hkv, D, Hd = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.hidden_size)
    W, full = cfg.sliding_window, _full(cfg)
    ring = cfg.num_layers - full
    tokens = rows * new
    lengths = [nkq + nkw for nkq, nkw, _, _ in history] or [0] * rows
    seen_full = tokens * (new + 1) / 2 if causal_new else 0
    seen_ring = hist = ring_bytes = 0.0
    for (nkq, nkw, nvq, nvw), n in zip(history or [(0,) * 4] * rows,
                                       lengths):
        seen_full += new * n
        if causal_new:
            seen_ring += _window_seen(n, new, W)
            ring_bytes += min(n, W - 1) * Hkv * D * BF16 * 2
        else:
            seen_ring += min(n, W)
            ring_bytes += min(n, W) * Hkv * D * BF16 * 2
        if history:
            hist += kivi_bytes(cfg, qcfg, nkq - shared[0], nkw,
                               nvq - shared[1], nvw)
    if history:
        hist += kivi_bytes(cfg, qcfg, shared[0], 0, shared[1], 0)
    E, k = cfg.num_experts, cfg.experts_per_tok
    held = len(cfg.experts_here)
    pairs = tokens * k * held / E
    hit = held * (1 - (1 - k / E) ** tokens)
    flops = (2 * tokens * layer_params(cfg)
             + 2 * _sparse(cfg) * pairs * _expert(cfg)
             + 2 * logit_rows * Hd * cfg.vocab_size
             + 4 * Hq * D * (full * seen_full + ring * seen_ring))
    written = full * tokens + ring * rows * min(new, W)
    nbytes = (weight_bytes(cfg) - _sparse(cfg) * _held_bytes(cfg)
              + _sparse(cfg) * hit * BF16 * _expert(cfg)
              + full * hist + ring * ring_bytes
              + written * Hkv * D * BF16 * 2
              + tokens * Hd * BF16 + logit_rows * cfg.vocab_size * 4)
    return flops, nbytes


def expert_gemm(cfg, counts) -> tuple:
    """(operations, bytes) of one grouped expert GEMM call (gate and up,
    then down) with counts[e] tokens on held expert e."""
    pairs = sum(counts)
    hit = sum(1 for c in counts if c)
    Hd = cfg.hidden_size
    return (2 * pairs * _expert(cfg),
            BF16 * (hit * _expert(cfg) + 2 * pairs * Hd))
