"""kivi_tpu_torch: the PyTorch/CUDA port of kivi-tpu for NVIDIA Hopper.

A second package beside the JAX reference `kivi_tpu`: the KIVI 2/4/8-bit
KV cache (keys quantized per channel, values per token, fp residual
windows), the model and the generation engine, with hand-written CUDA
kernels for the cache's hot path (kernels/csrc/).  It imports torch and
numpy, never JAX or the JAX package.

Entry points run on CUDA unless the caller passes device="cpu", where
every kernel wrapper takes its plain PyTorch version.

It holds the KIVI serving main path (chunked prefill through the extend
attention, or one-shot prefill through flash attention, then
greedy/sampled decode), the fp16-cache baseline engine beside it, and
the continuous batcher with its HTTP front end (serving/batcher.py,
serving/api.py) over either cache, speculative decoding at batch 1 and
over the batcher's slots (serving/speculative.py,
serving/spec_batcher.py), and the HF checkpoint loader
(models/hf_loader.py) with the port's own checkpoint format
(models/checkpoint.py).
"""

from kivi_tpu_torch.config import (PRESETS, ModelConfig, QuantConfig,
                                   tiny_config)
from kivi_tpu_torch.models.hf_loader import (config_from_hf,
                                             load_hf_checkpoint,
                                             params_from_state_dict)
from kivi_tpu_torch.serving.spec_batcher import SpeculativeBatcher
from kivi_tpu_torch.serving.speculative import SpeculativeEngine

__all__ = ["PRESETS", "ModelConfig", "QuantConfig", "tiny_config",
           "SpeculativeEngine", "SpeculativeBatcher", "config_from_hf",
           "params_from_state_dict", "load_hf_checkpoint"]
