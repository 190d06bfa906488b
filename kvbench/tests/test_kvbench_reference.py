"""The plain reference agrees with the port on the CPU: the port's model
and KIVI cache in f32 (modeling.forward over host-int caches: a prompt
ingested at once, an extend, decode steps with their flushes) against
reference/model.py on the same weights and tokens, logits at every
compared position; and the reference imports nothing of the port."""

import subprocess
import sys

import pytest
import torch

from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models import modeling
from kvbench import weights
from kvbench.reference import kivi
from kvbench.reference import model as ref

QCFG = QuantConfig(2, 2, 32, 128, v_flush=128)
# f32 on both sides; the rare 2-bit code that a different summation
# order moves across a rounding edge stays far below a flipped token
TOL = 2e-3


def _port_logits(cfg, params, prompt, pad, rows, extend):
    """The port's logits at the prompt's last token and each row token."""
    R, M = rows.shape
    T0 = len(prompt)
    caches = modeling.init_caches(cfg, QCFG, R, 512,
                                  dtype=torch.float32, device="cpu")
    toks = torch.cat([torch.zeros(pad, dtype=torch.long), prompt])
    toks = toks.expand(R, -1)
    pos = torch.clamp(torch.arange(pad + T0) - pad, min=0).expand(R, -1)
    padv = torch.full((R,), pad) if pad else None
    lg, _ = modeling.forward(params, toks, caches, cfg, QCFG, pos,
                             mode="prefill", pad_len=padv)
    out = [lg[:, -1]]
    c = pad + T0
    if extend:
        p = (torch.arange(c, c + extend) - pad).expand(R, -1)
        lg, _ = modeling.forward(params, rows[:, :extend], caches, cfg,
                                 QCFG, p, mode="extend", prev_len=c,
                                 pad_len=padv)
        out += list(lg.unbind(1))
        c += extend
    for m in range(extend, M):
        p = torch.full((R, 1), c - pad)
        lg, _ = modeling.forward(params, rows[:, m:m + 1], caches, cfg,
                                 QCFG, p, mode="decode", pad_len=padv)
        out.append(lg[:, -1])
        c += 1
    return torch.stack(out, 1)


@pytest.mark.parametrize("kv,pad,T0,extend,M", [
    (2, 0, 350, 16, 60),      # docqa: prompt, extend, decode past flushes
    (4, 37, 219, 0, 170),     # chat: left pad to a bucket, decode
    (2, 0, 128, 0, 200),      # a prompt of exactly one window
])
def test_reference_matches_port(kv, pad, T0, extend, M):
    cfg = tiny_config(vocab_size=512, num_kv_heads=kv, head_dim=32)
    params = weights.program_params(
        weights.make_params(cfg, 7, "cpu", dtype=torch.float32))
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 512, (T0,), generator=g)
    rows = torch.randint(0, 512, (2, M), generator=g)
    got = _port_logits(cfg, params, prompt, pad, rows, extend)
    want = ref.logits(params, cfg, QCFG, [ref.group(
        prompt, pad, rows, 128, 128, extend=extend)])[0]
    err = (got - want).abs().max().item()
    assert err < TOL, err


def test_views_follow_the_policy():
    v = kivi.Views(128, 128).prefill(350).extend(16).decode(60)
    # the extend's queries see the prompt's ingest: 256 quantized keys,
    # values rounded up to v_flush past the window
    assert v.nkq[350] == 256 and v.nvq[350] == 256
    # decode from slot 366: a full window (slot 384) flushes both
    assert v.nkq[383] == 256 and v.nkq[384] == 384 and v.nvq[384] == 384
    assert kivi.decode_counts(366, 18, 128, 128) == (384, 1, 384, 1)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import kvbench.reference.model, "
            "kvbench.reference.kivi; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'kivi_tpu_torch', 'kivi_tpu', 'jax'}); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=weights.__file__.rsplit("/kvbench",
                                                             1)[0])
    assert r.returncode == 0, r.stdout + r.stderr
