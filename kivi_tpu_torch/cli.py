"""CLI flag system: port of `kivi_tpu/cli.py`.

One typed surface for the quantization and engine flags.  `parse`
returns (the argparse namespace, QuantConfig, EngineArgs), the JAX
package's flags with the same names and defaults.

`--impl` keeps the JAX package's two values, which the port maps to its
own choice of where the model runs: "pallas" (the default) runs on the
card, through the hand-written CUDA kernels; "jnp" runs the kernels'
plain PyTorch versions on the CPU (`impl_device`).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from kivi_tpu_torch.config import PRESETS, QuantConfig

# --impl -> the device the model runs on
IMPL_DEVICE = {"pallas": "cuda", "jnp": "cpu"}


@dataclasses.dataclass(frozen=True)
class EngineArgs:
    model_dir: Optional[str]
    preset: Optional[str]
    max_seq_len: int
    batch_size: int
    impl: str
    mesh_data: int
    mesh_model: int


def add_quant_flags(ap: argparse.ArgumentParser):
    g = ap.add_argument_group("kivi quantization")
    g.add_argument("--k-bits", type=int, default=2,
                   help="key cache bits: 2/4/8, 16 = fp cache")
    g.add_argument("--v-bits", type=int, default=2)
    g.add_argument("--group-size", type=int, default=32)
    g.add_argument("--residual", type=int, default=128,
                   help="fp16 residual window length")
    g.add_argument("--v-flush", type=int, default=0,
                   help="value window flush block (0 = group-size); 128 "
                        "keeps values in fp longer than the reference's "
                        "1-token slide")
    g.add_argument("--scale-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])


def add_engine_flags(ap: argparse.ArgumentParser):
    g = ap.add_argument_group("engine")
    g.add_argument("--model-dir", default=None,
                   help="local HF checkpoint directory")
    g.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="architecture preset (random weights)")
    g.add_argument("--max-seq-len", type=int, default=4096)
    g.add_argument("--batch-size", type=int, default=1)
    g.add_argument("--impl", default="pallas", choices=sorted(IMPL_DEVICE),
                   help="pallas: the CUDA kernels on the card; jnp: their "
                        "plain PyTorch versions on the CPU")
    g.add_argument("--mesh-data", type=int, default=1)
    g.add_argument("--mesh-model", type=int, default=1)


def quant_config_from_args(args) -> QuantConfig:
    """Build a QuantConfig from a parser that used add_quant_flags."""
    return QuantConfig(k_bits=args.k_bits, v_bits=args.v_bits,
                       group_size=args.group_size,
                       residual_length=args.residual,
                       v_flush=getattr(args, "v_flush", 0),
                       scale_dtype=getattr(args, "scale_dtype", "bfloat16"))


def parse(argv=None, extra=None):
    ap = argparse.ArgumentParser()
    add_quant_flags(ap)
    add_engine_flags(ap)
    if extra:
        extra(ap)
    args = ap.parse_args(argv)
    qcfg = quant_config_from_args(args)
    eargs = EngineArgs(model_dir=args.model_dir, preset=args.preset,
                       max_seq_len=args.max_seq_len,
                       batch_size=args.batch_size, impl=args.impl,
                       mesh_data=args.mesh_data,
                       mesh_model=args.mesh_model)
    return args, qcfg, eargs


def impl_device(eargs: EngineArgs) -> str:
    """The device `--impl` selects."""
    return IMPL_DEVICE[eargs.impl]


def load_model(eargs: EngineArgs):
    """(ModelConfig, params) from --model-dir (the HF loader) or --preset
    (random weights, seed 0), on the device --impl selects."""
    device = impl_device(eargs)
    if eargs.model_dir:
        from kivi_tpu_torch.models.hf_loader import load_hf_checkpoint
        return load_hf_checkpoint(eargs.model_dir, device=device)
    from kivi_tpu_torch.models import modeling
    cfg = PRESETS[eargs.preset or "llama2-7b"]
    return cfg, modeling.init_params(cfg, seed=0, device=device)
