"""A stall injected inside the window moves the end-to-end metrics the
way a slower program would: gen_tok_s falls, itl_p90_ms rises."""

import time

from kivi_tpu_torch.serving.batcher import ContinuousBatcher
from kivi_tpu_torch.serving.engine import Engine
from kvbench import run

SEED = 99


def _stalled(fn, s):
    def wrapped(*a, **kw):
        time.sleep(s)
        return fn(*a, **kw)
    return wrapped


def test_stall_lowers_gen_tok_s(tiny_root, monkeypatch):
    base, _ = run.run_cell(tiny_root, "tiny-gqa.docqa", SEED, 2.0, False,
                           "cpu")
    monkeypatch.setattr(Engine, "generate", _stalled(Engine.generate, 5.0))
    slow, _ = run.run_cell(tiny_root, "tiny-gqa.docqa", SEED, 2.0, False,
                           "cpu")
    b, s = (r["metrics"]["gen_tok_s"]["value"] for r in (base, slow))
    assert s < 0.7 * b, (b, s)


def test_stall_raises_itl_p90(tiny_root, monkeypatch):
    base, _ = run.run_cell(tiny_root, "tiny-mha.chat", SEED, 2.0, False,
                           "cpu")
    monkeypatch.setattr(ContinuousBatcher, "step",
                        _stalled(ContinuousBatcher.step, 0.4))
    slow, _ = run.run_cell(tiny_root, "tiny-mha.chat", SEED, 2.0, False,
                           "cpu")
    b, s = (r["metrics"]["itl_p90_ms"]["value"] for r in (base, slow))
    assert s > b + 300, (b, s)
