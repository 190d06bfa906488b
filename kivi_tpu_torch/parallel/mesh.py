"""Device mesh and sharding: port of `kivi_tpu/parallel/mesh.py`.

A 2-D `torch.distributed.device_mesh.DeviceMesh` with the JAX package's
axes (one process per device):

  * ``data``  — batch data parallelism: each data rank holds its own
    batch rows;
  * ``model`` — tensor parallelism over attention heads and MLP columns
    (Megatron-style).

The JAX package annotates its pytrees with shardings and lets XLA insert
the collectives.  The port has no GSPMD: each rank holds its own slices
of the weights and caches (the pure functions below cut them), and the
model calls the collectives itself (`models/modeling.py` through
`utils/collectives.py`: an all-reduce after the attention's output
projection and after the MLP's down projection, an all-gather of the
vocab-split logits).  The quantized KV
stores, scales and zero points are cut along the KV-head axis, so packed
words never cross devices.

Constraints: the mesh's `model` size divides num_kv_heads (8 for
Llama-3-8B / Mistral-7B, 32 for Llama-2-7B), num_heads,
intermediate_size and vocab_size, and `data` divides the batch.

A process group of size 1 issues no collective (`group_of` gives None
for it), so a (1, 1) mesh runs exactly the single-device program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: int, n_model: int, device=None):
    """A (data, model) DeviceMesh over every process of the initialized
    default group (`multihost.initialize`), n_data * n_model of them.
    Model is the fast-varying axis (ranks r and r+1 share a data row),
    so each tensor-parallel group is made of neighbouring ranks: on one
    host, the devices NVLink joins."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    return init_device_mesh(device.type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def auto_mesh_shape(n_devices: int, num_kv_heads: int) -> tuple[int, int]:
    """Pick (n_data, n_model): the largest model axis that divides both
    the device count and the KV head count; the remainder goes to data."""
    n_model = 1
    for cand in range(min(n_devices, num_kv_heads), 0, -1):
        if n_devices % cand == 0 and num_kv_heads % cand == 0:
            n_model = cand
            break
    return n_devices // n_model, n_model


def mesh_coords(mesh) -> Tuple[int, int, int, int]:
    """(n_data, data_rank, n_model, model_rank) of this process in a
    (data, model) mesh; None means (1, 0, 1, 0)."""
    if mesh is None:
        return 1, 0, 1, 0
    return (mesh.size(0), mesh.get_local_rank(DATA_AXIS),
            mesh.size(1), mesh.get_local_rank(MODEL_AXIS))


def group_of(mesh, axis: str):
    """The process group of `axis` through this rank, or None when the
    mesh is None or the axis has size 1: the model then issues no
    collective along it."""
    if mesh is None or mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} = {n} is not divisible by the {parts}-way "
                         "mesh axis")
    return n // parts


def local_config(cfg: ModelConfig, n_model: int) -> ModelConfig:
    """The config of one tensor-parallel rank's slice of the model: the
    head counts and the MLP width divided by n_model (head_dim, the
    hidden size and the vocabulary stay; the logits are gathered back to
    the whole vocabulary).  Raises when the axis does not divide them."""
    if n_model == 1:
        return cfg
    _split(cfg.vocab_size, n_model, "vocab_size")
    return dataclasses.replace(
        cfg, num_heads=_split(cfg.num_heads, n_model, "num_heads"),
        num_kv_heads=_split(cfg.num_kv_heads, n_model, "num_kv_heads"),
        intermediate_size=_split(cfg.intermediate_size, n_model,
                                 "intermediate_size"))


def local_batch(batch: int, n_data: int) -> int:
    """Rows of a batch that one data rank holds; raises unless the data
    axis divides the batch."""
    return _split(batch, n_data, "the batch")


# ---------------------------------------------------------------------------
# which dim of each array is split over a mesh axis (the JAX PartitionSpecs)
# ---------------------------------------------------------------------------

def param_pspecs(cfg: Optional[ModelConfig] = None) -> dict:
    """The dim of each weight split over "model" (None: replicated), in
    the port's layout ((in, out) matrices, one dict per layer; the JAX
    specs name the same dims of its stacked (L, in, out) arrays).

    Attention Q/K/V are column-parallel (heads), the output projection
    row-parallel; MLP gate/up column-parallel, down row-parallel; lm_head
    column-parallel over the vocabulary.  Embedding and norms
    replicated."""
    layers = {"ln_attn": None, "ln_mlp": None,
              "wq": 1, "wk": 1, "wv": 1, "wo": 0,
              "wg": 1, "wu": 1, "wd": 0}
    return {"embed": None, "layers": layers, "ln_f": None, "lm_head": 1}


def cache_pspecs(qcfg: QuantConfig) -> dict:
    """For ONE layer's cache, each field's split: "bh" for the stores
    (B, H, ...): batch over "data", KV heads over "model"; "b" for a
    slot cache's per-row counters (host-int counters are replicated)."""
    if qcfg.quantize_kv:
        stores = ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale",
                  "v_mn", "k_win", "v_win")
        counters = ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win")
    else:
        stores, counters = ("k", "v"), ("length",)
    return {**{f: "bh" for f in stores}, **{f: "b" for f in counters}}


def token_pspec() -> str:
    """Tokens (B, T): batch over "data"."""
    return "b"


def _cut(x: torch.Tensor, dim: int, n: int, rank: int) -> torch.Tensor:
    if n == 1:
        return x
    size = _split(x.shape[dim], n, f"dim {dim} of a {tuple(x.shape)} array")
    return x.narrow(dim, rank * size, size).contiguous()


def shard_params(params: dict, cfg: ModelConfig, n_model: int,
                 model_rank: int) -> dict:
    """This tensor-parallel rank's slices of the port's params (each a
    contiguous copy; the tensors themselves when n_model is 1), for
    Engine / ContinuousBatcher(mesh=)."""
    local_config(cfg, n_model)          # raises on an indivisible axis
    spec = param_pspecs(cfg)

    def cut(x, dim):
        return x if dim is None else _cut(x, dim, n_model, model_rank)

    return {"embed": cut(params["embed"], spec["embed"]),
            "layers": [{k: cut(w, spec["layers"][k]) for k, w in lp.items()}
                       for lp in params["layers"]],
            "ln_f": cut(params["ln_f"], spec["ln_f"]),
            "lm_head": cut(params["lm_head"], spec["lm_head"])}


def shard_caches(caches, qcfg: QuantConfig, n_data: int, data_rank: int,
                 n_model: int, model_rank: int) -> list:
    """This rank's slices of per-layer caches (a list): rows over "data",
    KV heads over "model"; host-int counters kept as they are."""
    spec = cache_pspecs(qcfg)
    out = []
    for c in caches:
        kw = {}
        for f, how in spec.items():
            x = getattr(c, f)
            if isinstance(x, torch.Tensor):
                x = _cut(x, 0, n_data, data_rank)
                if how == "bh":
                    x = _cut(x, 1, n_model, model_rank)
            kw[f] = x
        out.append(dataclasses.replace(c, **kw))
    return out


def shard_tokens(tokens: torch.Tensor, n_data: int,
                 data_rank: int) -> torch.Tensor:
    """This data rank's rows of a (B, ...) batch."""
    return _cut(tokens, 0, n_data, data_rank)


def check_local_params(params: dict, cfg: ModelConfig) -> None:
    """Raise unless params hold one tensor-parallel rank's slice for the
    local config cfg (the K projection's width tells)."""
    want = cfg.num_kv_heads * cfg.head_dim
    got = params["layers"][0]["wk"].shape[1]
    if got != want:
        raise ValueError(f"params hold {got} K columns, this rank's slice "
                         f"has {want}: pass shard_params(...) of the model")
