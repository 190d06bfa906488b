"""Typed configuration for the PyTorch/CUDA port of the kivi-tpu engine.

The port's own copy of `kivi_tpu/config.py`: the same two frozen
dataclasses, presets and validation, so that both packages are driven by
identical knobs while the port never imports the JAX package.
`QuantConfig` holds the KIVI algorithm knobs, `ModelConfig` the
architecture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """KIVI quantization knobs.

    Mirrors the reference's config attributes (reference
    `models/llama_kivi.py:34-38`, defaults `utils/process_args.py:36-43`):
      * k_bits / v_bits: 2, 4 or 8 (16 = no quantization, fp16-cache baseline,
        like the reference's `mem_spd_test.py:23-41` fallback).
      * group_size: elements per quantization group (per-channel groups along
        tokens for K, per-token groups along channels for V).
      * residual_length: number of most-recent tokens kept in full precision.

    Addition over the reference (kept from the JAX package):
      * v_flush: how many of the oldest fp window tokens are quantized at once
        when the value window fills.  The reference slides the value window by
        exactly 1 token per step (`models/llama_kivi.py:174-187`); a 1-token
        flush is hostile to static shapes, so we flush `v_flush` tokens
        (default = group_size) wholesale.  Consequence: the fp16 coverage of
        the most recent value tokens oscillates in
        (residual_length - v_flush, residual_length] instead of being exactly
        residual_length.  Keys already behave this way in the reference
        (block flush of residual_length, `models/llama_kivi.py:131-144`).
    """

    k_bits: int = 2
    v_bits: int = 2
    group_size: int = 32
    residual_length: int = 128
    v_flush: int = 0  # 0 => group_size
    # Storage dtype for per-group scales/zero-points.  The reference
    # stores fp16 (`quant/new_pack.py:240-241` casts to input dtype);
    # bf16 halves scale-store bytes vs f32 — at group_size=32 scales
    # are 50% of the 2-bit store.  "float32" for bit-exact comparisons
    # against the plain reference.
    scale_dtype: str = "bfloat16"

    def __post_init__(self):
        for b in (self.k_bits, self.v_bits):
            if b not in (2, 4, 8, 16):
                raise ValueError(f"bits must be one of 2,4,8,16, got {b}")
        if (self.k_bits == 16) != (self.v_bits == 16):
            # K and V are either both quantized or both fp: the cache is
            # one structure (KiviLayerCache xor FpLayerCache), and mixed
            # configs crash deep inside init_layer_cache.  Reference
            # asserts the same (`models/llama_kivi.py:34-38`).
            raise ValueError(
                "mixed fp/quantized K/V unsupported: k_bits and v_bits "
                "must both be 16 (fp cache) or both be < 16")
        if self.residual_length % self.group_size != 0:
            # Same invariant as reference `models/llama_kivi.py:132`.
            raise ValueError(
                "residual_length must be a multiple of group_size")
        vf = self.v_flush or self.group_size
        if vf % self.group_size != 0 or vf > self.residual_length:
            raise ValueError("v_flush must be a multiple of group_size and "
                             "<= residual_length")

    @property
    def value_flush(self) -> int:
        return self.v_flush or self.group_size

    @property
    def quantize_kv(self) -> bool:
        return self.k_bits < 16 or self.v_bits < 16


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer architecture description.

    Covers the Llama-2/3, LongChat and Mistral families the reference
    supports (`models/llama_kivi.py`, `models/mistral_kivi.py`).
    """

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # Rope scaling factor (LongChat-7b-v1.5-32K: linear 8.0; Llama-3.1:
    # llama3 8.0).  Interpretation depends on rope_scaling_kind:
    #   "linear": positions divided by the factor (HF "linear");
    #   "llama3": frequency-dependent NTK scheme (HF "llama3") — low
    #     frequencies divided by the factor, high frequencies kept,
    #     smooth ramp between, controlled by the three fields below.
    rope_scaling: Optional[float] = None
    rope_scaling_kind: str = "linear"
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    # Mistral-style sliding window attention; None = full causal.
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 4096
    dtype: str = "bfloat16"

    @property
    def num_query_groups(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads


# Known model presets (geometry from the HF configs of the models the
# reference evaluates; see reference `config/model2path.json`).
LLAMA2_7B = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_layers=32, num_heads=32, num_kv_heads=32, rope_theta=10000.0,
    max_position_embeddings=4096,
)
LONGCHAT_7B_32K = dataclasses.replace(
    LLAMA2_7B, rope_scaling=8.0, max_position_embeddings=32768,
)
LLAMA3_8B = ModelConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
    max_position_embeddings=8192,
)
MISTRAL_7B = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1000000.0,
    sliding_window=None,  # v0.2 dropped the sliding window
    max_position_embeddings=32768,
)

LLAMA31_8B = dataclasses.replace(
    LLAMA3_8B, rope_scaling=8.0, rope_scaling_kind="llama3",
    rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
    rope_original_max_position=8192, max_position_embeddings=131072,
)

PRESETS = {
    "llama2-7b": LLAMA2_7B,
    "longchat-7b-32k": LONGCHAT_7B_32K,
    "llama3-8b": LLAMA3_8B,
    "llama3.1-8b": LLAMA31_8B,
    "mistral-7b": MISTRAL_7B,
}


def tiny_config(**overrides) -> ModelConfig:
    """A small config for tests; GQA by default (the fully-supported
    reference path is flash+GQA, SURVEY.md cross-file notes)."""
    base = dict(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
        max_position_embeddings=512,
    )
    base.update(overrides)
    return ModelConfig(**base)
