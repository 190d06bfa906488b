"""The port's CLI flags (kivi_tpu_torch.cli) against kivi_tpu.cli on the
same argv: the parsed namespace, QuantConfig and EngineArgs equal
field for field; load_model's config equal and its weights of the same
shapes from a preset (both draw random weights from seed 0, each with
its own generator), and bit-equal to the JAX loader's from an HF
directory.  `--impl` picks the device: "pallas" the card, "jnp" the
CPU.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from kivi_tpu import cli as jcli
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu_torch import cli
from kivi_tpu_torch.config import PRESETS, QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax

ARGVS = [
    [],
    ["--k-bits", "4", "--v-bits", "4", "--group-size", "64",
     "--residual", "256", "--v-flush", "128", "--scale-dtype", "float32"],
    ["--k-bits", "16", "--v-bits", "16", "--preset", sorted(PRESETS)[0],
     "--batch-size", "8", "--impl", "jnp", "--max-seq-len", "1024",
     "--mesh-data", "2", "--mesh-model", "4"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_matches_jax(argv):
    args, qcfg, eargs = cli.parse(argv)
    jargs, jqcfg, jeargs = jcli.parse(argv)
    assert vars(args) == vars(jargs)
    assert dataclasses.asdict(qcfg) == dataclasses.asdict(jqcfg)
    assert dataclasses.asdict(eargs) == dataclasses.asdict(jeargs)


def test_parse_defaults_extra_and_refusals():
    args, qcfg, eargs = cli.parse([])
    assert qcfg == QuantConfig()
    assert eargs.impl == "pallas" and eargs.batch_size == 1
    assert cli.impl_device(eargs) == "cuda"

    def extra(ap):
        ap.add_argument("--my-flag", type=int, default=3)

    args, _, eargs = cli.parse(["--impl", "jnp", "--my-flag", "7"],
                               extra=extra)
    assert args.my_flag == 7 and cli.impl_device(eargs) == "cpu"
    with pytest.raises(ValueError):
        cli.parse(["--k-bits", "16", "--v-bits", "2"])   # mixed fp/quant


def _eargs(**kw):
    base = dict(model_dir=None, preset=None, max_seq_len=128, batch_size=1,
                impl="jnp", mesh_data=1, mesh_model=1)
    return cli.EngineArgs(**{**base, **kw})


def test_load_model_preset_matches_jax(monkeypatch):
    # every shipped preset is 7B-class (too big to init in a unit test):
    # register a tiny one through the dicts load_model reads
    monkeypatch.setitem(cli.PRESETS, "test-tiny", tiny_config())
    monkeypatch.setitem(jcli.PRESETS, "test-tiny", j_tiny_config())
    cfg, params = cli.load_model(_eargs(preset="test-tiny"))
    jcfg, jparams = jcli.load_model(jcli.EngineArgs(**dataclasses.asdict(
        _eargs(preset="test-tiny"))))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           "cpu")
    for k in ("embed", "ln_f", "lm_head"):
        assert params[k].shape == want[k].shape
        assert params[k].dtype == want[k].dtype == torch.bfloat16
        assert params[k].device.type == "cpu"
    for a, b in zip(params["layers"], want["layers"]):
        assert {n: t.shape for n, t in a.items()} == \
            {n: t.shape for n, t in b.items()}


def test_load_model_dir_matches_jax(tmp_path):
    from safetensors.numpy import save_file
    from transformers import LlamaConfig

    hf = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=256)
    (tmp_path / "config.json").write_text(json.dumps(hf.to_dict()))
    rng = np.random.default_rng(0)
    shapes = {"model.embed_tokens.weight": (128, 64),
              "model.norm.weight": (64,), "lm_head.weight": (128, 64)}
    for i in range(2):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (64,),
                       p + "post_attention_layernorm.weight": (64,),
                       p + "self_attn.q_proj.weight": (64, 64),
                       p + "self_attn.k_proj.weight": (32, 64),
                       p + "self_attn.v_proj.weight": (32, 64),
                       p + "self_attn.o_proj.weight": (64, 64),
                       p + "mlp.gate_proj.weight": (128, 64),
                       p + "mlp.up_proj.weight": (128, 64),
                       p + "mlp.down_proj.weight": (64, 128)})
    save_file({k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()},
              str(tmp_path / "model.safetensors"))
    ea = _eargs(model_dir=str(tmp_path))
    cfg, params = cli.load_model(ea)
    jcfg, jparams = jcli.load_model(jcli.EngineArgs(
        **dataclasses.asdict(ea)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           "cpu")
    for k in ("embed", "ln_f", "lm_head"):
        assert torch.equal(params[k], want[k]), k
    for a, b in zip(params["layers"], want["layers"]):
        for n in a:
            assert torch.equal(a[n], b[n]), n
