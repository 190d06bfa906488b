"""Each cell's files are found by name and a run goes end to end on the
CPU at a tiny configuration, through the port's plain paths, the check
included."""

import pytest

from kvbench import run
from kvbench.tests.tiny import CELLS

SEED = 2 ** 31 + 12345          # seeds past 32 signed bits


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_end_to_end(tiny_root, cell):
    res, rec = run.run_cell(tiny_root, cell, SEED, 2.0, False, "cpu")
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in run.metrics_for(
        run.load_cell(tiny_root, cell, SEED, 2.0, False, "cpu")[0], cell,
        False)}
    assert set(res["metrics"]) == want
    assert res["metrics"]["setup_s"]["value"] > 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_traced_host_metrics(tiny_root, cell):
    """A traced run on the CPU reports the metrics of host spans and
    counts, and nothing read from a device."""
    res, _ = run.run_cell(tiny_root, cell, SEED, 2.0, True, "cpu")
    got = set(res["metrics"])
    host = {"prompt_share.gen", "decode_step_ms.gen"} if "docqa" in cell \
        else {"queue_wait_p50_ms.ttft", "admit_ms.ttft",
              "decode_step_ms.itl"}
    assert got == host
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_same_seed_same_inputs(tiny_root):
    from kvbench.drivers import batcher_open, engine_jobs
    _, _, c = run.load_cell(tiny_root, "tiny-gqa.docqa", SEED, 1.0, False,
                            "cpu")
    a, b = engine_jobs.inputs(c, 3), engine_jobs.inputs(c, 3)
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    _, _, c = run.load_cell(tiny_root, "tiny-mha.chat", SEED, 1.0, False,
                            "cpu")
    s1 = batcher_open.schedule(c)
    c.seed = SEED + 1
    s2 = batcher_open.schedule(c)
    # another seed: the same arrivals, and the same lengths in the window
    # in another order
    assert (s1["due"] == s2["due"]).all()
    w = (s1["due"] >= 0) & (s1["due"] < c.seconds)
    assert sorted(s1["plen"][w]) == sorted(s2["plen"][w])
    assert sorted(s1["olen"][w]) == sorted(s2["olen"][w])
    assert s1["greedy"][w].sum() == s2["greedy"][w].sum()
    assert (s1["plen"] != s2["plen"]).any()
