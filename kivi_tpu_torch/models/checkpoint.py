"""The port's own checkpoint format: port of
`kivi_tpu/models/checkpoint.py` (`save_checkpoint`, `load_checkpoint`,
`convert_hf`).

Convert an HF checkpoint once (`load_hf_checkpoint` +
`save_checkpoint`), then restart from the native format.  The JAX
package writes an orbax tree, which the machine with the card does not
have; the port writes

  <dir>/config.json   the ModelConfig fields (plain JSON)
  <dir>/params.pt     `torch.save` of the parameter dict on the CPU

and reads it back with `torch.load(weights_only=True)`, as the prefix
snapshot on disk does (serving/engine.py).  The two formats do not read
each other.  `load_checkpoint(mesh=)` (restoring straight into a
sharding) comes with the port of parallel/.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import torch

from kivi_tpu_torch.config import ModelConfig
from kivi_tpu_torch.utils.device import resolve_device


def _to(params, device) -> dict:
    return {k: ([{n: t.to(device) for n, t in lp.items()} for lp in v]
                if k == "layers" else v.to(device))
            for k, v in params.items()}


def save_checkpoint(path: str, params: dict, cfg: ModelConfig) -> None:
    """Write params (the port's parameter dict) and cfg under path."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    torch.save(_to(params, "cpu"), os.path.join(path, "params.pt"))


def load_checkpoint(path: str, device=None, mesh=None
                    ) -> Tuple[ModelConfig, dict]:
    """(cfg, params) written by save_checkpoint, the tensors on `device`
    (CUDA unless told otherwise) in the dtypes they were saved in."""
    if mesh is not None:
        raise NotImplementedError(
            "load_checkpoint(mesh=): sharded restore comes with the port "
            "of parallel/ (ROADMAP Queue 1 item 7)")
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = ModelConfig(**json.load(f))
    params = torch.load(os.path.join(path, "params.pt"), map_location=device,
                        weights_only=True)
    return cfg, params


def convert_hf(hf_dir: str, out_dir: str, dtype=None) -> ModelConfig:
    """One-shot HF safetensors -> native checkpoint conversion (the
    tensors pass through the CPU)."""
    from kivi_tpu_torch.models.hf_loader import load_hf_checkpoint

    cfg, params = load_hf_checkpoint(
        hf_dir, dtype=dtype if dtype is not None else torch.bfloat16,
        device="cpu")
    save_checkpoint(out_dir, params, cfg)
    return cfg
