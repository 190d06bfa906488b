"""Random weights from the seed, made on the device in the type they are
served in, in the port's parameter layout (`kivi_tpu_torch.models.modeling`:
matrices (in, out), a list of per-layer dicts).

Each kind of matrix is drawn for all layers at once into one bf16 tensor
from a `torch.Generator` on the device, and scaled in place: nine draws
for the whole model.  The scales are those of the port's `init_params`
(normal, 1 / sqrt(fan-in); the embedding unit normal; norms at one), so
activations keep their size through the depth.
"""

from __future__ import annotations

import torch

_KINDS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def _shapes(cfg) -> dict:
    Hd, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    return {"wq": (Hd, cfg.num_heads * D), "wk": (Hd, cfg.num_kv_heads * D),
            "wv": (Hd, cfg.num_kv_heads * D), "wo": (cfg.num_heads * D, Hd),
            "wg": (Hd, I), "wu": (Hd, I), "wd": (I, Hd)}


def make_params(cfg, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The model's weights for `seed`: {"embed", "layers", "ln_f",
    "lm_head"}, every matrix a view into one tensor per kind."""
    L, Hd, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    stacks = {k: torch.empty((L, *s), dtype=dtype, device=device)
              for k, s in _shapes(cfg).items()}
    params = {"embed": torch.empty((V, Hd), dtype=dtype, device=device),
              "lm_head": torch.empty((Hd, V), dtype=dtype, device=device),
              "ln_f": torch.ones(Hd, dtype=dtype, device=device)}
    norms = torch.ones((2, L, Hd), dtype=dtype, device=device)
    params["layers"] = [dict({k: stacks[k][i] for k in _KINDS},
                             ln_attn=norms[0, i], ln_mlp=norms[1, i])
                        for i in range(L)]
    params["_stacks"] = stacks
    refill(params, cfg, seed)
    return params


def refill(params: dict, cfg, seed: int) -> None:
    """Draw the weights of `seed` into the tensors of `params` in place
    (their addresses, which captured CUDA graphs read, stay)."""
    dev = params["embed"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    s = cfg.hidden_size ** -0.5
    scales = dict({k: s for k in _KINDS}, wd=cfg.intermediate_size ** -0.5)
    for k, t in params["_stacks"].items():
        _normal_(t, gen, scales[k])
    _normal_(params["embed"], gen, 1.0)
    _normal_(params["lm_head"], gen, s)


def _normal_(t: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    torch.randn(t.shape, generator=gen, dtype=t.dtype, device=t.device,
                out=t)
    t.mul_(scale)


def program_params(params: dict) -> dict:
    """The dict the program takes (without the benchmark's own keys)."""
    return {k: v for k, v in params.items() if not k.startswith("_")}
