"""HF checkpoint -> the port's parameters: port of
`kivi_tpu/models/hf_loader.py` (`config_from_hf`,
`params_from_state_dict`, `load_hf_checkpoint`,
`load_hf_checkpoint_native`).

Reads safetensors shards directly into the port's parameter dict, with
the name mapping of the Llama and Mistral families, from

  * a directory of *.safetensors plus config.json, or
  * an in-memory state dict of numpy arrays or torch tensors keyed by HF
    names (as the tests compare against `transformers` with the same
    random weights).

The machine with the card has neither `safetensors` nor `transformers`,
so the port reads the format itself (`SafetensorsFile`): an 8-byte
little-endian header length, a JSON header naming each tensor's dtype,
shape and byte range, then the raw bytes.  Tensors are read lazily, one
at a time, as the JAX loader's `_Lazy` does; BF16 is kept as 16-bit
words viewed as torch.bfloat16.  `load_hf_checkpoint_native` reads the
same shards through the C++ mmap reader instead (models/native_io.py).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping

import numpy as np
import torch

from kivi_tpu_torch.config import ModelConfig
from kivi_tpu_torch.utils.device import resolve_device


def config_from_hf(hf_cfg: Mapping) -> ModelConfig:
    """Map an HF config dict (llama / mistral style) to ModelConfig:
    linear and llama3 rope scaling, Mistral's sliding window, tied
    embeddings (kivi_tpu/models/hf_loader.py:25-70)."""
    rope_scaling = None
    rope_kind = "linear"
    rope_lo, rope_hi, rope_orig = 1.0, 4.0, 8192
    rs = hf_cfg.get("rope_scaling")
    if rs:
        kind = rs.get("rope_type", rs.get("type"))
        if kind == "linear":
            rope_scaling = float(rs["factor"])
        elif kind == "llama3":
            # Llama-3.1's frequency-dependent scheme (HF
            # modeling_rope_utils._compute_llama3_parameters)
            rope_scaling = float(rs["factor"])
            rope_kind = "llama3"
            rope_lo = float(rs.get("low_freq_factor", 1.0))
            rope_hi = float(rs.get("high_freq_factor", 4.0))
            rope_orig = int(rs.get("original_max_position_embeddings",
                                   8192))
        elif kind not in (None, "default"):
            raise ValueError(f"unsupported rope_scaling type {kind!r}")
    n_heads = hf_cfg["num_attention_heads"]
    return ModelConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=n_heads,
        num_kv_heads=hf_cfg.get("num_key_value_heads", n_heads),
        head_dim=(hf_cfg.get("head_dim")
                  or hf_cfg["hidden_size"] // n_heads),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-5),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        rope_scaling_kind=rope_kind,
        rope_low_freq_factor=rope_lo,
        rope_high_freq_factor=rope_hi,
        rope_original_max_position=rope_orig,
        sliding_window=hf_cfg.get("sliding_window"),
        tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 4096),
    )


def _tensor(a) -> torch.Tensor:
    """A state-dict value as a torch tensor: torch as is; numpy through
    f32 when its dtype is ml_dtypes' bfloat16 (no torch counterpart)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def params_from_state_dict(sd: Mapping, cfg: ModelConfig,
                           dtype=torch.bfloat16, device=None) -> dict:
    """Convert an HF llama / mistral state dict (numpy arrays or torch
    tensors) to the port's parameters {"embed", "layers": [per-layer
    dict], "ln_f", "lm_head"} on `device` (CUDA unless told otherwise)
    in `dtype`.  HF linear weights are (out, in); the port's are (in,
    out), so they are transposed.  The cast rounds to nearest even, as
    the JAX loader's jnp.asarray(..., dtype) does."""
    device = resolve_device(device)

    def get(name):
        return _tensor(sd[name]).to(device=device, dtype=dtype)

    def lin(name):
        return _tensor(sd[name]).to(device=device, dtype=dtype).t(
        ).contiguous()

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layers.append({
            "ln_attn": get(p + "input_layernorm.weight"),
            "ln_mlp": get(p + "post_attention_layernorm.weight"),
            "wq": lin(p + "self_attn.q_proj.weight"),
            "wk": lin(p + "self_attn.k_proj.weight"),
            "wv": lin(p + "self_attn.v_proj.weight"),
            "wo": lin(p + "self_attn.o_proj.weight"),
            "wg": lin(p + "mlp.gate_proj.weight"),
            "wu": lin(p + "mlp.up_proj.weight"),
            "wd": lin(p + "mlp.down_proj.weight"),
        })
    embed = get("model.embed_tokens.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
        lm_head = embed.t().contiguous()
    else:
        lm_head = lin("lm_head.weight")
    return {"embed": embed, "layers": layers,
            "ln_f": get("model.norm.weight"), "lm_head": lm_head}


# safetensors dtype names -> (numpy dtype of the stored words, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


class SafetensorsFile:
    """One .safetensors shard, read with numpy and json: the header at
    open, each tensor's bytes only when asked for (`get`)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.base = 8 + n
        self.header = header

    def keys(self):
        return self.header.keys()

    def get(self, name: str) -> torch.Tensor:
        """The tensor `name` on the CPU, in its stored dtype."""
        meta = self.header[name]
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{self.path}: {name} has unsupported dtype "
                             f"{meta['dtype']}")
        words, tdt = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        with open(self.path, "rb") as f:
            f.seek(self.base + start)
            raw = bytearray(f.read(end - start))
        arr = np.frombuffer(raw, dtype=np.dtype(words).newbyteorder("<"))
        t = torch.from_numpy(arr.astype(words, copy=False))
        return t.view(tdt).reshape(meta["shape"])


class _LazyStateDict(dict):
    """The shards' tensors by name, each read when looked up, so that
    host memory holds about one tensor at a time."""

    def __init__(self, files):
        super().__init__()
        self.where = {k: f for f in files for k in f.keys()}

    def __getitem__(self, k):
        return self.where[k].get(k)

    def __contains__(self, k):
        return k in self.where


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device=None):
    """(ModelConfig, params) from a local HF model directory: config.json
    and every *.safetensors shard in it (an index json, if any, is not
    needed: each shard's header names its tensors)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    shards = sorted(f for f in os.listdir(path)
                    if f.endswith(".safetensors"))
    sd: Dict = _LazyStateDict([SafetensorsFile(os.path.join(path, s))
                               for s in shards])
    return cfg, params_from_state_dict(sd, cfg, dtype, device)


def load_hf_checkpoint_native(path: str, dtype=torch.bfloat16, device=None):
    """load_hf_checkpoint through the C++ mmap reader
    (native/safetensors_reader.cpp, models/native_io.py): each tensor
    is a zero-copy view of its mapped shard until the cast or the copy
    to the device.  Raises when the reader cannot be built or a shard
    cannot be opened; it never falls back to the Python reader.  On the
    CPU, a parameter already in the stored dtype and layout (norms, the
    embedding) stays a view of the read-only mapping."""
    from kivi_tpu_torch.models import native_io

    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    shards = sorted(os.path.join(path, f) for f in os.listdir(path)
                    if f.endswith(".safetensors"))
    where = native_io.open_shards(shards)

    class _NativeStateDict(dict):
        def __getitem__(self, k):
            return where[k].get(k)

        def __contains__(self, k):
            return k in where

    return cfg, params_from_state_dict(_NativeStateDict(), cfg, dtype,
                                       device)
