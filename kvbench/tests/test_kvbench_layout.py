"""The benchmark is driven by data: a new cell, traffic mix and per-layer
metric are new files and new entries, and run with nothing else changed;
and a run loads neither JAX nor the JAX package (top-level names compared
whole: `kivi_tpu_torch` is the port, `kivi_tpu` is not)."""

import json
import os
import subprocess
import sys

from kvbench import run
from kvbench.tests.tiny import REPO


def test_new_cell_mix_and_metric_are_files_and_entries(tiny_root):
    with open(os.path.join(tiny_root, "kvbench", "traffic",
                           "tiny-docqa.json")) as f:
        mix = json.load(f)
    mix.update(doc_tokens=200, questions=2, new_tokens=20,
               check=dict(mix["check"], rows=2))
    with open(os.path.join(tiny_root, "kvbench", "traffic",
                           "tiny-docqa-short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(tiny_root, "kvbench", "metrics",
                           "jobs_done.gen.py"), "w") as f:
        f.write('"""jobs_done.gen: jobs in the window."""\n\n\n'
                "def read(rec):\n    return len(rec.jobs) or None\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny-mha.docqa-short",
                               "config": "tiny-mha",
                               "traffic": "tiny-docqa-short", "chips": 1,
                               "why": "a cell added by files alone"})
    for m in bench["end_to_end"]:
        if m["name"] == "gen_tok_s":
            m["workloads"].append("tiny-mha.docqa-short")
    bench["per_layer"].append({
        "name": "jobs_done.gen", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "engine (serving/engine.py)",
        "moves": "gen_tok_s", "workloads": ["tiny-mha.docqa-short"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    res, _ = run.run_cell(tiny_root, "tiny-mha.docqa-short", 5, 1.0, True,
                          "cpu")
    assert res["correct"]
    assert res["metrics"]["jobs_done.gen"]["value"] >= 1
    res, _ = run.run_cell(tiny_root, "tiny-mha.docqa-short", 5, 1.0, False,
                          "cpu")
    assert set(res["metrics"]) == {"gen_tok_s", "setup_s"}


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys; sys.path.insert(0, %r); from kvbench import run; "
            "run.run_cell(%r, 'tiny-mha.chat', 3, 1.0, True, 'cpu'); "
            "run.run_cell(%r, 'tiny-gqa.docqa', 3, 1.0, False, 'cpu'); "
            "print(run.forbidden_modules()); "
            "print('kivi_tpu_torch' in sys.modules)"
            % (REPO, tiny_root, tiny_root))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[-3:-1] == ["[]", "True"]


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kivi_tpu_torch_extra", sys)
    assert "kivi_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kivi_tpu.config", sys)
    assert "kivi_tpu" in run.forbidden_modules()


def test_alone_the_benchmark_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and kvbench/ cannot run."""
    import shutil
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "kvbench"), tmp_path / "kvbench")
    r = subprocess.run([sys.executable, "kvbench/run.py", "--workload",
                        "mistral-7b.docqa-12k", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()
