"""Model families: everything the harness knows of a block's equations.

A configuration file names its family (`"family": "llama"`), and the
family is one file, `kvbench/families/<family>.py`, found by that name
under the root the cell runs from.  It exports:

    config(conf) -> (model config, QuantConfig)
        the port's config objects from the file's `model` and `quant`
        sections;
    make_params(cfg, seed, device) -> params
        the weights of `seed`, made on the device;
    refill(params, cfg, seed)
        the weights of `seed` drawn into the same tensors in place;
    program_params(params) -> dict
        the part of params that the program takes;
    reference
        the plain reference, a module that imports nothing of the port:
        `Group`, `group(prompt, pad, rows, W, vf, extend=0)`,
        `logits(params, cfg, qcfg, groups, low=, kv_of=)`, `gaps`,
        `window_gap`, `exact_matmuls`, and the cache policy the drivers
        count with: `decode_counts(prompt, k, W, vf)` and
        `quantized_values_at_ingest(T, W, vf)`;
    roofline
        the block's counts: `layer_params`, `weight_bytes`,
        `forward(cfg, qcfg, rows, new, history=, shared=, logit_rows=,
        causal_new=)`, `decode_attention(cfg, qcfg, rows, shared=)` (one
        layer) and `decode_layers(cfg)` (the layers that run it).

What no block changes stays shared and is not part of a family:
`roofline.bound_s`, the peaks and `kivi_bytes`, the readers, the traces
and the spans.
"""

from __future__ import annotations

import importlib.util
import os

INTERFACE = ("config", "make_params", "refill", "program_params",
             "reference", "roofline")
REFERENCE = ("Group", "group", "logits", "gaps", "window_gap",
             "exact_matmuls", "decode_counts", "quantized_values_at_ingest")
ROOFLINE = ("layer_params", "weight_bytes", "forward", "decode_attention",
            "decode_layers")


def load(root: str, conf: dict, where: str):
    """The family module that the configuration `conf` (read from the
    file `where`) names, from root's kvbench/families/."""
    name = conf.get("family")
    if not isinstance(name, str) or not name:
        raise SystemExit(f"{where} names no family: give it \"family\": "
                         f"\"<name>\" for kvbench/families/<name>.py")
    path = os.path.join(root, "kvbench", "families", name + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"{where} names the family {name!r}, and there is "
                         f"no {path}")
    spec = importlib.util.spec_from_file_location(f"kvbench_family_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = ([k for k in INTERFACE if not hasattr(mod, k)]
               + [f"reference.{k}" for k in REFERENCE
                  if not hasattr(getattr(mod, "reference", None), k)]
               + [f"roofline.{k}" for k in ROOFLINE
                  if not hasattr(getattr(mod, "roofline", None), k)])
    if missing:
        raise SystemExit(f"{path} lacks {', '.join(missing)}")
    return mod
