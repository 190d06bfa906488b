"""The port's HF checkpoint loader and checkpoint format
(kivi_tpu_torch.models.hf_loader, models.checkpoint; CPU) against the
JAX package's loader and against `transformers`, as
tests/test_model_vs_hf.py does for the JAX package:

  * config_from_hf field by field equal to the JAX function's (Llama
    with linear and llama3 rope scaling, Mistral with a sliding window,
    tied embeddings);
  * params_from_state_dict bit-equal to params_from_jax of the JAX
    loader's output on one random state dict (bf16, and f32);
  * the port's forward logits against LlamaForCausalLM and
    MistralForCausalLM with random tiny configs (f32, fp cache;
    rtol = atol = 2e-3, the JAX test's tolerance);
  * load_hf_checkpoint from a directory written here with the
    `safetensors` package (BF16 and F32, one and two shards), read by
    the port's own reader, equal to the in-memory path;
  * save_checkpoint / load_checkpoint and convert_hf bit-equal round
    trips.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from transformers import (LlamaConfig, LlamaForCausalLM, MistralConfig,
                          MistralForCausalLM)

from kivi_tpu.models import hf_loader as JH
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.models import checkpoint as TCK
from kivi_tpu_torch.models import hf_loader as TH
from kivi_tpu_torch.models import modeling as TM
from kivi_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

FP = QuantConfig(k_bits=16, v_bits=16, group_size=16, residual_length=16)


def _llama(gqa=True, rope_scaling=None, tie=False, seed=0):
    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2 if gqa else 4, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=rope_scaling,
        tie_word_embeddings=tie, attn_implementation="eager")
    torch.manual_seed(seed)
    return cfg, LlamaForCausalLM(cfg).eval()


def _mistral(sliding_window=None, seed=3):
    cfg = MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, sliding_window=sliding_window,
        attn_implementation="eager")
    torch.manual_seed(seed)
    return cfg, MistralForCausalLM(cfg).eval()


LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
CONFIGS = {
    "llama": lambda: _llama()[0].to_dict(),
    "llama-mha": lambda: _llama(gqa=False)[0].to_dict(),
    "llama-linear": lambda: _llama(rope_scaling={"rope_type": "linear",
                                                 "factor": 4.0})[0].to_dict(),
    "llama3": lambda: _llama(rope_scaling=LLAMA3)[0].to_dict(),
    "llama-tied": lambda: _llama(tie=True)[0].to_dict(),
    "mistral-swa": lambda: _mistral(sliding_window=4096)[0].to_dict(),
    "legacy-type-key": lambda: {**_llama()[0].to_dict(), "rope_scaling": {
        "type": "linear", "factor": 2.0}},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_from_hf_matches_jax(name):
    hf = CONFIGS[name]()
    got = dataclasses.asdict(TH.config_from_hf(hf))
    want = dataclasses.asdict(JH.config_from_hf(hf))
    assert got == want


def test_config_from_hf_refuses_unknown_rope():
    hf = {**_llama()[0].to_dict(), "rope_scaling": {"rope_type": "yarn",
                                                    "factor": 2.0}}
    with pytest.raises(ValueError, match="yarn"):
        TH.config_from_hf(hf)


def _random_sd(cfg, seed=0, tie=False):
    """A random HF-named state dict in numpy f32 for cfg."""
    rng = np.random.default_rng(seed)
    Hd, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (V, Hd),
              "model.norm.weight": (Hd,)}
    if not tie:
        shapes["lm_head.weight"] = (V, Hd)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (Hd,),
            p + "post_attention_layernorm.weight": (Hd,),
            p + "self_attn.q_proj.weight": (q, Hd),
            p + "self_attn.k_proj.weight": (kv, Hd),
            p + "self_attn.v_proj.weight": (kv, Hd),
            p + "self_attn.o_proj.weight": (Hd, q),
            p + "mlp.gate_proj.weight": (I, Hd),
            p + "mlp.up_proj.weight": (I, Hd),
            p + "mlp.down_proj.weight": (Hd, I)})
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _assert_params_equal(got, want):
    for k in ("embed", "ln_f", "lm_head"):
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    assert len(got["layers"]) == len(want["layers"])
    for i, (a, b) in enumerate(zip(got["layers"], want["layers"])):
        assert a.keys() == b.keys()
        for n in a:
            assert a[n].dtype == b[n].dtype
            torch.testing.assert_close(a[n], b[n], rtol=0, atol=0,
                                       msg=f"layer {i} {n}")


@pytest.mark.parametrize("dtype,tie", [("bfloat16", False),
                                       ("float32", False),
                                       ("bfloat16", True)])
def test_params_from_state_dict_bit_equal_to_jax_loader(dtype, tie):
    """One random state dict through the port's loader and through the
    JAX loader + params_from_jax: every tensor bit-equal (the casts to
    bf16 both round to nearest even)."""
    cfg = TH.config_from_hf(_llama(tie=tie)[0].to_dict())
    sd = _random_sd(cfg, seed=1, tie=tie)
    got = TH.params_from_state_dict(sd, cfg, dtype=getattr(torch, dtype),
                                    device="cpu")
    jp = JH.params_from_state_dict(sd, JH.config_from_hf(
        _llama(tie=tie)[0].to_dict()), dtype=getattr(jnp, dtype))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                           getattr(torch, dtype))
    _assert_params_equal(got, want)
    # torch tensors in the state dict take the same path
    _assert_params_equal(TH.params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
        dtype=getattr(torch, dtype), device="cpu"), got)


def _port_logits(cfg, params, toks):
    B, T = toks.shape
    caches = TM.init_caches(cfg, FP, B, 128, dtype=torch.float32,
                            device="cpu")
    positions = torch.arange(T).expand(B, T)
    logits, _ = TM.forward(params, torch.from_numpy(toks), caches, cfg, FP,
                           positions, mode="prefill")
    return logits.numpy()


@pytest.mark.parametrize("which", ["llama-gqa", "llama-mha", "llama3",
                                   "llama-linear", "llama-tied", "mistral"])
def test_forward_logits_match_transformers(which):
    """The port's forward (fp cache, f32) against transformers' on the
    same random tiny model, converted through params_from_state_dict."""
    if which == "mistral":
        hf_cfg, model = _mistral()
    else:
        rope = {"llama3": LLAMA3, "llama-linear": {
            "rope_type": "linear", "factor": 4.0}}.get(which)
        hf_cfg, model = _llama(gqa=which != "llama-mha", rope_scaling=rope,
                               tie=which == "llama-tied")
    cfg = TH.config_from_hf(hf_cfg.to_dict())
    sd = {k: v for k, v in model.state_dict().items()}
    params = TH.params_from_state_dict(sd, cfg, dtype=torch.float32,
                                       device="cpu")
    T = 96 if which == "llama3" else 24    # llama3: past original max 64
    toks = np.random.default_rng(len(which)).integers(0, 128, (2, T))
    with torch.no_grad():
        ref = model(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(_port_logits(cfg, params, toks), ref,
                               rtol=2e-3, atol=2e-3)


def _write_dir(path, sd, hf_cfg, dtype, shards):
    """An HF model directory written with the safetensors package."""
    import ml_dtypes
    os.makedirs(path, exist_ok=True)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "BF16" \
        else (lambda a: a.astype(np.float32))
    names = sorted(sd)
    for i in range(shards):
        part = {n: cast(sd[n]) for n in names[i::shards]}
        save_file(part, os.path.join(
            path, f"model-{i + 1:05d}-of-{shards:05d}.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg.to_dict(), f)


@pytest.mark.parametrize("dtype,shards", [("BF16", 1), ("BF16", 2),
                                          ("F32", 2)])
def test_load_hf_checkpoint_equals_in_memory_path(tmp_path, dtype, shards):
    """A directory written by the safetensors package, read back by the
    port's own reader: the same config and bit-equal parameters as the
    in-memory state dict (cast as stored) through params_from_state_dict,
    in bf16 and in f32."""
    import ml_dtypes
    hf_cfg, model = _llama(seed=4)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _write_dir(str(tmp_path), sd, hf_cfg, dtype, shards)
    stored = ({k: v.astype(ml_dtypes.bfloat16) for k, v in sd.items()}
              if dtype == "BF16" else sd)
    for out_dtype in (torch.bfloat16, torch.float32):
        cfg, got = TH.load_hf_checkpoint(str(tmp_path), dtype=out_dtype,
                                         device="cpu")
        assert cfg == TH.config_from_hf(hf_cfg.to_dict())
        _assert_params_equal(got, TH.params_from_state_dict(
            stored, cfg, dtype=out_dtype, device="cpu"))


def test_safetensors_reader_reads_each_dtype(tmp_path):
    """The numpy reader against the safetensors package on every dtype a
    checkpoint may hold, one tensor at a time."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "bf16": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        "f64": rng.standard_normal((2,)),
        "i64": rng.integers(-9, 9, (3,)),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "bool": rng.random(4) > 0.5}
    path = str(tmp_path / "t.safetensors")
    save_file(arrays, path)
    f = TH.SafetensorsFile(path)
    assert set(f.keys()) == set(arrays)
    for name, a in arrays.items():
        t = f.get(name)
        if name == "bf16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(),
                                          a.astype(np.float32))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_checkpoint_round_trip_and_convert_hf(tmp_path):
    """save_checkpoint / load_checkpoint: the config and every tensor
    bit-equal (dtype kept); convert_hf of an HF directory equals
    load_hf_checkpoint of it; a sharded restore waits for parallel/."""
    hf_cfg, model = _llama(seed=5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _write_dir(str(tmp_path / "hf"), sd, hf_cfg, "BF16", 1)
    cfg, params = TH.load_hf_checkpoint(str(tmp_path / "hf"), device="cpu")
    TCK.save_checkpoint(str(tmp_path / "native"), params, cfg)
    cfg2, params2 = TCK.load_checkpoint(str(tmp_path / "native"),
                                        device="cpu")
    assert cfg2 == cfg
    _assert_params_equal(params2, params)
    cfg3 = TCK.convert_hf(str(tmp_path / "hf"), str(tmp_path / "conv"))
    assert cfg3 == cfg
    _assert_params_equal(TCK.load_checkpoint(str(tmp_path / "conv"),
                                             device="cpu")[1], params)
    with pytest.raises(NotImplementedError, match="parallel"):
        TCK.load_checkpoint(str(tmp_path / "native"), mesh=object())
