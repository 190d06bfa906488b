"""The check fails what it must.  A run with the timed path broken
underneath (the harness's look for a card skipped: device "cpu", the
tiny cells) comes out not correct, for each fault a serving cell can
have (`kvbench/faults.py`): a token altered where it is produced, a
decode step that returns its state unchanged, a decode step that leaves
the KV cache as it was (at the real depth: 30 or 32 layers), one that
moves the cache's counters but writes no key or value.  The control, the reference in fp8
in the program's place, reads above a limit.  (Half of a batch left out
with the mean over the rest, and an exchange between chips left out,
are faults of training and of more than one chip: these cells have
neither.)"""

import pytest
import torch

from kvbench import faults, run, weights
from kvbench.record import Record
from kvbench.reference import model as ref
from kvbench.tests.tiny import CELLS

SEED = 2 ** 31 + 777


def _failed(res) -> list:
    return [k for k, c in res["check"].items() if c["value"] > c["limit"]]


def _run_with(root, cell, fault, seconds):
    undo = faults.plant(fault)
    try:
        res, _ = run.run_cell(root, cell, SEED, seconds, False, "cpu")
    finally:
        undo()
    return res


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_altered_token_is_not_correct(tiny_root, cell):
    res = _run_with(tiny_root, cell, "altered-token", 1.5)
    assert not res["correct"]
    assert "gap" in _failed(res)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_unchanged_step_is_not_correct(tiny_root, cell):
    res = _run_with(tiny_root, cell, "frozen-step", 1.5)
    assert not res["correct"]
    assert "gap" in _failed(res)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_skipped_cache_append_is_not_correct(deep_root, cell):
    """At the real depth, narrow: the step's tokens flow, but no decode
    step writes its keys and values, so every later position misses the
    answer's own tokens."""
    res = _run_with(deep_root, cell, "skip-append", 3.0)
    assert not res["correct"]
    assert _failed(res), res["check"]


def test_stale_window_is_not_correct(tiny_root):
    """The engine's decode steps move the counters but write nothing into
    the windows: the windows' keys and values read far from the
    reference's, whatever the tokens do."""
    res = _run_with(tiny_root, "tiny-gqa.docqa", "stale-window", 1.5)
    assert not res["correct"]
    assert "window_kv" in _failed(res), res["check"]


def test_faults_come_out_again(tiny_root):
    """A fault is taken out by its undo: the next run is correct."""
    _run_with(tiny_root, "tiny-mha.chat", "skip-append", 2.0)
    res, _ = run.run_cell(tiny_root, "tiny-mha.chat", SEED, 2.0, False,
                          "cpu")
    assert res["correct"], res["check"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_reads_above_the_limit(deep_root, cell):
    """At the real depth (30 or 32 layers), narrow: the control's error
    grows with depth, and at 8 layers it can read under the limit."""
    bench, wl, c = run.load_cell(deep_root, cell, SEED, 6.0, False,
                                 torch.device("cpu"))
    drv = run._load(f"{deep_root}/kvbench/drivers/"
                    f"{c.traffic['driver']}.py", "kvbench_driver")
    params = weights.make_params(c.cfg, SEED, c.device)
    st = drv.setup(c, weights.program_params(params))
    rec = Record(cfg=c.cfg, qcfg=c.qcfg, traffic=c.traffic, seconds=6.0,
                 spans=c.spans)
    drv.window(st, c, rec)
    got, ctl = run.reference_check(ref, params, c,
                                   drv.check_items(st, c, rec),
                                   control=True)
    limits = c.traffic["check"]["limits"]
    assert all(got[k] <= lim for k, lim in limits.items()), (got, limits)
    assert any(ctl[k] > lim for k, lim in limits.items()), (ctl, limits)
