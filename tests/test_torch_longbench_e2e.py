"""The port's LongBench runner (kivi_tpu_torch.evalsuite.run_longbench)
end to end against the JAX runner (kivi_tpu.evalsuite.run_longbench),
offline: a tiny HF checkpoint and tokenizer written by the test (the
recipe of tests/test_longbench_e2e.py), LongBench-format jsonl data,
`predict` with --impl jnp --scale-dtype float32, one-shot and with
--prefill-chunk 64, then `score`.

Tolerance: none.  The predictions must be equal record for record and
the result.json files byte for byte.  Both runners load the checkpoint
in f32 and keep their windows in f32 here (the loaders and the engines
patched for the test, the same on both sides): a randomly initialised
model's logits are nearly flat (init std 0.02), so bf16 rounding
differences between XLA and torch flip greedy argmaxes at near ties.
The CLIs as shipped (bf16) are run too, for well-formed output.
"""

import functools
import json
import os

import pytest
import torch

TASKS = ("hotpotqa", "passage_count")
SAMPLES = [
    {"input": "what is the answer", "context": "the story is a story " * 30,
     "answers": ["yes"], "length": 600, "all_classes": None},
    {"input": "how many paragraphs", "context": "one two three " * 20,
     "answers": ["3"], "length": 300, "all_classes": None},
]
FLAGS = ["--k-bits", "2", "--v-bits", "2", "--group-size", "16",
         "--residual", "16", "--max-len", "640", "--limit", "2",
         "--impl", "jnp", "--scale-dtype", "float32"]


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import (LlamaConfig, LlamaForCausalLM,
                              PreTrainedTokenizerFast)

    d = tmp_path_factory.mktemp("tiny_llama_ckpt")
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in ("the a is of and question answer story report code "
              "paragraph number one two three summary yes no "
              "unanswerable next line").split():
        vocab[w] = len(vocab)
    for i in range(128 - len(vocab)):
        vocab[f"w{i}"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            bos_token="<s>", eos_token="</s>"
                            ).save_pretrained(d)
    cfg = LlamaConfig(vocab_size=128, hidden_size=64,
                      intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512)
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("longbench_data")
    for task in TASKS:
        with open(d / f"{task}.jsonl", "w") as f:
            for s in SAMPLES:
                f.write(json.dumps(s) + "\n")
    return str(d)


def _argv(ckpt, data, out, chunk):
    return (["predict", "--model-dir", ckpt, "--data-dir", data,
             "--out-dir", out, "--tasks", ",".join(TASKS)] + FLAGS
            + ["--prefill-chunk", str(chunk)])


def _jax_predict(ckpt, data, out, chunk):
    import jax.numpy as jnp

    import kivi_tpu.models.hf_loader as HL
    from kivi_tpu.evalsuite import run_longbench
    from kivi_tpu.serving.engine import Engine

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(Engine, "cache_dtype", jnp.float32)
        mp.setattr(HL, "load_hf_checkpoint", functools.partial(
            HL.load_hf_checkpoint, dtype=jnp.float32))
        run_longbench.main(_argv(ckpt, data, out, chunk))
    finally:
        mp.undo()


def _port_predict(ckpt, data, out, chunk):
    import kivi_tpu_torch.models.hf_loader as HL
    import kivi_tpu_torch.serving.engine as EM
    from kivi_tpu_torch.evalsuite import run_longbench

    class F32Engine(EM.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, cache_dtype=torch.float32, **kw)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(EM, "Engine", F32Engine)
        mp.setattr(HL, "load_hf_checkpoint", functools.partial(
            HL.load_hf_checkpoint, dtype=torch.float32))
        run_longbench.main(_argv(ckpt, data, out, chunk))
    finally:
        mp.undo()


def _rows(d, task):
    with open(os.path.join(d, f"{task}.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("chunk", [0, 64])
def test_predict_and_score_match_jax(hf_checkpoint, data_dir, tmp_path,
                                     chunk, capsys):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_predict(hf_checkpoint, data_dir, jdir, chunk)
    _port_predict(hf_checkpoint, data_dir, tdir, chunk)
    for task in TASKS:
        got, want = _rows(tdir, task), _rows(jdir, task)
        assert len(got) == len(want) == len(SAMPLES)
        assert got == want, task

    from kivi_tpu.evalsuite import run_longbench as JR
    from kivi_tpu_torch.evalsuite import run_longbench as TR
    capsys.readouterr()
    JR.main(["score", "--pred-dir", jdir])
    jout = capsys.readouterr().out
    TR.main(["score", "--pred-dir", tdir])
    tout = capsys.readouterr().out
    assert json.loads(tout) == json.loads(jout)
    assert set(json.loads(tout)) == set(TASKS)
    with open(os.path.join(tdir, "result.json")) as f, \
            open(os.path.join(jdir, "result.json")) as g:
        assert f.read() == g.read()


def test_shipped_cli_runs_and_refuses_the_card_without_cuda(
        hf_checkpoint, data_dir, tmp_path):
    """The CLI unpatched (bf16 weights and windows): well-formed
    predictions one-shot and chunked, scores in [0, 100]; --impl pallas
    raises without CUDA rather than running on the host."""
    from kivi_tpu_torch.evalsuite import run_longbench
    from kivi_tpu_torch.evalsuite.longbench import score_dir
    for chunk in (0, 64):
        out = str(tmp_path / f"pred{chunk}")
        run_longbench.main(_argv(hf_checkpoint, data_dir, out, chunk))
        for task in TASKS:
            rows = _rows(out, task)
            assert len(rows) == 2
            assert all(isinstance(r["pred"], str) for r in rows)
        for v in score_dir(out).values():
            assert 0.0 <= v <= 100.0
    if not torch.cuda.is_available():
        argv = [a if a != "jnp" else "pallas"
                for a in _argv(hf_checkpoint, data_dir,
                               str(tmp_path / "card"), 0)]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_longbench.main(argv)
