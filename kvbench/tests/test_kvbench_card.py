"""On the card (skipped without one): each real cell runs a short window
with the trace on, comes out correct, and reads every per-layer metric
it lists, the device's busy time and the breakdown included.

    python -m pytest kvbench/tests -m card
"""

import json
import os

import pytest

from kvbench import run
from kvbench.tests.tiny import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    res, _ = run.run_cell(REPO, cell, 2 ** 31 + 5, 8.0, True, card)
    assert res["correct"], res["check"]
    bench = run.load_cell(REPO, cell, 1, 1.0, True, card)[0]
    assert set(res["metrics"]) == {m["name"] for m in
                                   run.metrics_for(bench, cell, True)}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
    for name, m in res["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
