"""The dense Llama block (Mistral, DeepSeek-LLM): pre-norm, RoPE on every
layer, attention to every earlier key, a SwiGLU MLP, the KIVI cache in
every layer.  The weights are `weights.py`'s, the reference
`reference/model.py`'s, the counts `roofline.py`'s."""

from kvbench import roofline, weights
from kvbench.reference import model as reference

make_params = weights.make_params
refill = weights.refill
program_params = weights.program_params


def config(conf: dict) -> tuple:
    from kivi_tpu_torch.config import ModelConfig, QuantConfig
    return ModelConfig(**conf["model"]), QuantConfig(**conf["quant"])
