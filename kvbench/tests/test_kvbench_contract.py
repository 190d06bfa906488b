"""BENCHMARK.json against the rules a run cannot show: its keys, names,
units, bounds and files, and a reader for every metric."""

import json
import os
import re

import pytest

from kvbench import families
from kvbench.tests.tiny import KVBENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"size|_dim$|_rank$|heads|head_dim|expert")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["kvbench"]
    assert bench["command"] == ["python3", "kvbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    n = len(bench["workloads"])
    # a full check at 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and 1 <= n <= 24


def test_configs(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("kvbench/")
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"] and conf["reduced"] == \
            c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert {"model", "quant", "published", "family"} <= set(conf)
        # the family's file is there and exports the whole interface
        fam = families.load(REPO, conf, c["file"])
        assert os.path.dirname(fam.__file__) == os.path.join(KVBENCH,
                                                             "families")


def test_workloads(bench):
    seen = set()
    cfgs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(KVBENCH, "traffic",
                                           w["traffic"] + ".json"))
    assert {c for _, c in [(0, w["config"]) for w in bench["workloads"]]} \
        == cfgs


def test_metrics(bench):
    names = set()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(KVBENCH, "metrics",
                                           m["name"] + ".py"))
    # every cell: setup_s, another end-to-end metric, a per-layer one
    for c in cells:
        got = [m for m in bench["end_to_end"] if c in m.get("workloads",
                                                             [c])]
        assert len(got) >= 2
        assert any(c in m.get("workloads", [c]) for m in bench["per_layer"])


def test_size_and_characters():
    with open(os.path.join(REPO, "BENCHMARK.json"), "rb") as f:
        raw = f.read()
    assert len(raw) <= 64 * 1024 and b"\t" not in raw
