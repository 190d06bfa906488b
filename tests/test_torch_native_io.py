"""The port's native safetensors reader (kivi_tpu_torch.models.native_io,
over native/safetensors_reader.cpp) and `load_hf_checkpoint_native`:

  * the reader builds into the port's build directory, never native/;
  * keys() lists every tensor in the file's order, a name longer than the
    first name buffer included (the grow-and-retry of
    kivi_tpu/models/native_io.py:84-89);
  * every dtype reads equal to `hf_loader.SafetensorsFile` and to the
    `safetensors` package, as zero-copy views that keep their shard
    alive;
  * load_hf_checkpoint_native gives load_hf_checkpoint's params on a
    real HF checkpoint (written by transformers);
  * a compiler that is missing or fails raises, with its output: the
    port never falls back to the Python reader.

Tolerance: none (bit-equal tensors).
"""

import gc
import json
import os
import weakref

import pytest
import torch
from safetensors.torch import load_file, save_file

from kivi_tpu_torch.models import hf_loader as HL
from kivi_tpu_torch.models import native_io as N

LONG = "model.layers.0." + "x" * (3 * N.NativeShard.NAME_BUF) + ".weight"


def _tensors():
    g = torch.Generator().manual_seed(0)
    r = torch.randn(3, 5, 7, generator=g)
    return {
        "f64": r.double(), "f32": r, "f16": r.half(), "bf16": r.bfloat16(),
        "i64": (r * 1e6).long(), "i32": (r * 1e6).int(),
        "i16": (r * 1e3).short(), "i8": (r * 40).to(torch.int8),
        "u8": (r.abs() * 40).to(torch.uint8), "bool": r > 0,
        "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
        "odd": torch.arange(3, dtype=torch.int8),   # misaligns what follows
        "after_odd": r[0].bfloat16(),
        LONG: torch.arange(6, dtype=torch.float32).reshape(2, 3),
    }


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("st") / "model.safetensors")
    save_file(_tensors(), path)
    return path


def test_builds_into_the_port_build_dir():
    so = N.build()
    assert so.exists() and so.parent == N.BUILD_DIR
    assert so.parent.name == "_build" and so.parent.parent.name == \
        "kivi_tpu_torch"
    assert N.library() is N.library()


def test_keys_in_file_order_with_a_long_name(shard):
    sh = N.NativeShard(shard)
    keys = sh.keys()
    assert len(LONG) > N.NativeShard.NAME_BUF
    assert LONG in keys
    assert keys == list(HL.SafetensorsFile(shard).keys())
    assert sorted(keys) == sorted(_tensors())


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_every_dtype_equals_both_readers(shard, name):
    got = N.NativeShard(shard).get(name)
    ref = load_file(shard)[name]
    py = HL.SafetensorsFile(shard).get(name)
    for want in (ref, py):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_views_keep_their_shard_alive(shard):
    sh = N.NativeShard(shard)
    t = sh.get("f32")
    w = weakref.ref(sh)
    del sh
    gc.collect()
    assert w() is not None              # the view holds the mapping
    assert torch.equal(t, load_file(shard)["f32"])
    del t
    gc.collect()
    assert w() is None                  # and lets it go after


def test_unknown_tensor_and_bad_file_raise(shard, tmp_path):
    with pytest.raises(KeyError):
        N.NativeShard(shard).get("nope")
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\xff" * 64)
    with pytest.raises(OSError):
        N.NativeShard(str(bad))


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM
    d = tmp_path_factory.mktemp("tiny_llama_ckpt")
    cfg = LlamaConfig(vocab_size=128, hidden_size=64,
                      intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512)
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    return str(d)


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_native_loader_equals_the_python_loader(hf_checkpoint, dtype):
    with open(os.path.join(hf_checkpoint, "config.json")) as f:
        assert json.load(f)["num_hidden_layers"] == 2
    cfg, want = HL.load_hf_checkpoint(hf_checkpoint, dtype, device="cpu")
    cfg2, got = HL.load_hf_checkpoint_native(hf_checkpoint, dtype,
                                             device="cpu")
    assert cfg2 == cfg
    _same(got, want)


@pytest.mark.parametrize("how", ["missing compiler", "failing compile"])
def test_a_failed_build_raises(monkeypatch, hf_checkpoint, how):
    monkeypatch.setattr(N, "_LIB", None)
    if how == "missing compiler":
        monkeypatch.setattr(N, "CXX", "/nonexistent/bin/g++")
        match = "nonexistent"
    else:
        monkeypatch.setattr(N, "CXX_FLAGS",
                            N.CXX_FLAGS + ["-fno-such-option-here"])
        match = "no-such-option-here"
    assert not N._target().exists()
    with pytest.raises(RuntimeError, match=match):
        N.library()
    with pytest.raises(RuntimeError, match=match):
        HL.load_hf_checkpoint_native(hf_checkpoint, device="cpu")
