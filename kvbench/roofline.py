"""Operations and bytes of the work the benchmark's inputs need, and the
least time the card could take for it.

The peaks are NVIDIA's published H100 SXM figures, copied from
`kivi_tpu_torch/utils/timing.py` (HBM_BYTES_PER_S, BF16_FLOP_PER_S); they
hold at the card's full 700 W power limit, which every run prints beside
its numbers.  A share of a roofline is least time / measured time.

What each function counts, and why (L layers, Hq / Hkv heads of D, hidden
Hd, MLP width I, vocabulary V; bf16 = 2 bytes):

| Function | Operations | Bytes | Why |
|---|---|---|---|
| `weight_bytes` | - | every layer's seven matrices, the two norms, the final norm and the head, once | a forward reads each weight once, however it is tiled |
| `kivi_bytes` (one layer, all KV heads) | - | per quantized token and head: D codes at k_bits / v_bits, plus a scale and a zero point in `scale_dtype` per group of `group_size` (keys: per channel over tokens; values: per token over channels); per window token: D keys or values in bf16 | what a reader of the KIVI cache cannot do without; about 96 B a token a head at 2 bits, group 32 |
| `decode_attention` (row 6 and any kernel that replaces it) | 4 Hq D per key read, per row | the live `kivi_bytes` of every row, a prefix shared by all rows once; each row's query and output in bf16 | the work of one decode step's attention in one layer, counted from the counters the inputs give, not from the kernel's grid |
| `forward` (prefill, extend or decode) | 2 x the weight parameters per token, 2 Hd V per logit row, 4 Hq D L per query and key it sees | `weight_bytes`; the history's `kivi_bytes` in every layer, a shared prefix once; the new tokens' keys and values written in bf16; the embedding rows; the f32 logits | the least a forward can move: what bounds the whole step (`mfu.*`) |

`bound_s`, the peaks and `kivi_bytes` are shared by every family;
`layer_params`, `weight_bytes`, `forward`, `decode_attention` and
`decode_layers` count the dense Llama block and are the `llama`
family's (`families/llama.py`): a family of another block brings its
own, and the harness reaches them through the cell's family alone.

A prefix that every row of a batch holds (the document of an
`engine_jobs` cell) is counted once: the inputs hold it once, whatever
copies the program makes.  Pads and padding to a bucket are not the
inputs' work and are not counted.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
BF16 = 2
_SCALE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of operations at the peak rate and
    bytes at the memory rate."""
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def layer_params(cfg) -> int:
    """Weight parameters of one layer's matrices."""
    Hd, D = cfg.hidden_size, cfg.head_dim
    return (Hd * cfg.num_heads * D * 2 + Hd * cfg.num_kv_heads * D * 2
            + 3 * Hd * cfg.intermediate_size)


def weight_bytes(cfg) -> int:
    Hd = cfg.hidden_size
    return BF16 * (cfg.num_layers * (layer_params(cfg) + 2 * Hd)
                   + Hd + Hd * cfg.vocab_size)


def kivi_bytes(cfg, qcfg, nkq: int, nkw: int, nvq: int, nvw: int) -> float:
    """Bytes of one layer's KIVI cache, every KV head, holding nkq / nvq
    quantized keys / values and nkw / nvw window ones."""
    D, gs = cfg.head_dim, qcfg.group_size
    sb = _SCALE_BYTES[qcfg.scale_dtype]
    k = nkq * D * (qcfg.k_bits / 8 + 2 * sb / gs) + nkw * D * BF16
    v = nvq * D * (qcfg.v_bits / 8 + 2 * sb / gs) + nvw * D * BF16
    return cfg.num_kv_heads * (k + v)


def decode_layers(cfg) -> int:
    """The layers whose decode attention `decode_attention` counts: all
    of them, each over its KIVI cache."""
    return cfg.num_layers


def decode_attention(cfg, qcfg, rows, shared=(0, 0)) -> tuple:
    """(operations, bytes) of one layer's decode attention over rows, each
    (nkq, nkw, nvq, nvw) as the step reads them; `shared` (keys, values)
    quantized tokens at the start of every row are the same bytes in each
    and are counted once."""
    Hq, D = cfg.num_heads, cfg.head_dim
    sk, sv = shared
    flops = nbytes = 0.0
    for nkq, nkw, nvq, nvw in rows:
        flops += 4 * Hq * D * (nkq + nkw)
        nbytes += kivi_bytes(cfg, qcfg, nkq - sk, nkw, nvq - sv, nvw)
    if rows:
        nbytes += kivi_bytes(cfg, qcfg, sk, 0, sv, 0)
    nbytes += len(rows) * Hq * D * BF16 * 2
    return flops, nbytes


def forward(cfg, qcfg, rows: int, new: int, history=(), shared=(0, 0),
            logit_rows: int = 0, causal_new: bool = True) -> tuple:
    """(operations, bytes) of one forward over `rows` rows of `new` new
    tokens each.  history: per row (nkq, nkw, nvq, nvw) of the cache it
    reads before its new tokens (empty for a prefill); shared: as in
    decode_attention.  causal_new: the new tokens attend each other
    causally (prefill, extend); a decode step's one new token is already
    in its history, so pass new=1, causal_new=False there."""
    L, Hq, D, Hd = (cfg.num_layers, cfg.num_heads, cfg.head_dim,
                    cfg.hidden_size)
    tokens = rows * new
    seen = tokens * (new + 1) / 2 if causal_new else 0
    hist = 0.0
    for nkq, nkw, nvq, nvw in history:
        seen += new * (nkq + nkw)
        hist += kivi_bytes(cfg, qcfg, nkq - shared[0], nkw, nvq - shared[1],
                           nvw)
    if history:
        hist += kivi_bytes(cfg, qcfg, shared[0], 0, shared[1], 0)
    flops = (2 * tokens * L * layer_params(cfg)
             + 2 * logit_rows * Hd * cfg.vocab_size + 4 * Hq * D * L * seen)
    nbytes = (weight_bytes(cfg) + L * hist
              + L * tokens * cfg.num_kv_heads * D * BF16 * 2
              + tokens * Hd * BF16 + logit_rows * cfg.vocab_size * 4)
    return flops, nbytes
