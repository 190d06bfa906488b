"""The llama family is the harness's earlier code, named: through it the
cells draw the same weights, bit for bit, and count the same work as they
did when the harness called `weights.py` and `roofline.py` directly."""

import hashlib
import json
import os

import pytest
import torch

from kvbench import families, run
from kvbench.tests.tiny import REPO

# sha256 of the weights that `weights.make_params` drew on the CPU (bf16)
# at commit cc159be, before the harness loaded families, for each tiny
# cell's configuration and seed (`_digest`'s order of tensors)
WEIGHTS = {
    ("tiny-gqa.docqa", 5):
        "1e08af2f0bee204852f150e85798ea8319c3a65f9d963269735b988affaa0346",
    ("tiny-gqa.docqa", 2 ** 31 + 12345):
        "9e186c993991d2f886df9d2fbcd6acda8a759fab8dc0368a84c4aeb7d702c994",
    ("tiny-mha.chat", 5):
        "dfafb230bcb4ffc746ed742dcd19a53e195f13b064966b5ae41dd59e09acfcf8",
    ("tiny-mha.chat", 2 ** 31 + 12345):
        "a92d11f6064a44aa0a3564ebba834fdb6da93f0433ee53b18d63ec7f53ce523b",
}

# `roofline.py`'s counts at the same commit, for the real configurations
DOC_ROWS = [(12032, 33, 12032, 33)] * 96
CHAT_ROWS = [(256, 77, 128, 205), (1024, 5, 1024, 5), (0, 100, 0, 100)]
SHARED = (11904, 11904)
COUNTS = {
    "mistral-7b-v0.2": {
        "weight_bytes": 14221320192, "layer_params": 218103808,
        "prefill": (205255868416000.0, 15892616192.0),
        "extend": (124546468282368.0, 16589758464.0),
        "decode": (1972446953472, 15256756224.0),
        "decode_ragged": (43428872192, 14284250112.0),
        "attention": (18976604160.0, 33128448.0),
        "attention_ragged": (23953408.0, 1990656.0)},
    "deepseek-llm-7b": {
        "weight_bytes": 12981870592, "layer_params": 202375168,
        "prefill": (181103348940800.0, 18978824192.0),
        "extend": (111021045841920.0, 21718343680.0),
        "decode": (1815509729280, 16855834624.0),
        "decode_ragged": (39662714880, 13217579008.0),
        "attention": (18976604160.0, 127795200.0),
        "attention_ragged": (23953408.0, 7815168.0)},
}


def _digest(params: dict) -> str:
    h = hashlib.sha256()
    for k in ("embed", "lm_head", "ln_f"):
        h.update(params[k].contiguous().view(torch.int16).numpy().tobytes())
    for lp in params["layers"]:
        for k in sorted(lp):
            h.update(lp[k].contiguous().view(torch.int16).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell,seed", sorted(WEIGHTS))
def test_family_draws_the_pinned_weights(tiny_root, cell, seed):
    _, _, c = run.load_cell(tiny_root, cell, seed, 1.0, False, "cpu")
    fam = c.family
    params = fam.make_params(c.cfg, seed, "cpu")
    assert _digest(fam.program_params(params)) == WEIGHTS[cell, seed]
    # refilled in place from another seed and back: the same bits
    fam.refill(params, c.cfg, seed + 1)
    assert _digest(fam.program_params(params)) != WEIGHTS[cell, seed]
    fam.refill(params, c.cfg, seed)
    assert _digest(fam.program_params(params)) == WEIGHTS[cell, seed]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_family_counts_the_pinned_work(name):
    path = f"kvbench/configs/{name}.json"
    with open(os.path.join(REPO, path)) as f:
        conf = json.load(f)
    fam = families.load(REPO, conf, path)
    cfg, q = fam.config(conf)
    r, want = fam.roofline, COUNTS[name]
    hist = [(11904, 96, 11904, 96)] * 96
    assert r.weight_bytes(cfg) == want["weight_bytes"]
    assert r.layer_params(cfg) == want["layer_params"]
    assert r.decode_layers(cfg) == cfg.num_layers
    got = {
        "prefill": r.forward(cfg, q, 1, 12000, logit_rows=1),
        "extend": r.forward(cfg, q, 96, 64, hist, SHARED, logit_rows=96),
        "decode": r.forward(cfg, q, 96, 1, DOC_ROWS, SHARED, logit_rows=96,
                            causal_new=False),
        "decode_ragged": r.forward(cfg, q, 3, 1, CHAT_ROWS, logit_rows=3,
                                   causal_new=False),
        "attention": r.decode_attention(cfg, q, DOC_ROWS, SHARED),
        "attention_ragged": r.decode_attention(cfg, q, CHAT_ROWS)}
    for k, v in got.items():
        assert v == want[k], (k, v, want[k])
