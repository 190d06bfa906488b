"""The benchmark is driven by data: a new cell, traffic mix, per-layer
metric and model family are new files and new entries, and run with
nothing else changed;
and a run loads neither JAX nor the JAX package (top-level names compared
whole: `kivi_tpu_torch` is the port, `kivi_tpu` is not)."""

import json
import os
import subprocess
import sys

import pytest

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


TINYWRAP = '''"""tinywrap: the llama block with each call counted, and weights
drawn under a seed of its own."""

import types

from kvbench.families import REFERENCE, ROOFLINE, llama

OFFSET = 1000003
CALLS = {"make_params": 0, "refill": 0, "logits": 0, "forward": 0}
MADE = []
config, program_params = llama.config, llama.program_params


def make_params(cfg, seed, device):
    CALLS["make_params"] += 1
    MADE.append(llama.make_params(cfg, seed + OFFSET, device))
    return MADE[-1]


def refill(params, cfg, seed):
    CALLS["refill"] += 1
    llama.refill(params, cfg, seed + OFFSET)


def _counted(name, fn):
    def wrapped(*a, **kw):
        CALLS[name] += 1
        return fn(*a, **kw)
    return wrapped


reference = types.SimpleNamespace(**dict(
    {k: getattr(llama.reference, k) for k in REFERENCE},
    logits=_counted("logits", llama.reference.logits)))
roofline = types.SimpleNamespace(**dict(
    {k: getattr(llama.roofline, k) for k in ROOFLINE},
    forward=_counted("forward", llama.roofline.forward)))
'''


def _add_config(root, name, conf_from, **over):
    """A configuration `name`, `conf_from`'s with `over` set (a value None
    drops its key), and a docqa cell `<name>.docqa` on it."""
    with open(os.path.join(root, "kvbench", "configs",
                           conf_from + ".json")) as f:
        conf = json.load(f)
    for k, v in over.items():
        if v is None:
            conf.pop(k, None)
        else:
            conf[k] = v
    path = f"kvbench/configs/{name}.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(conf, f)
    bpath = os.path.join(root, "BENCHMARK.json")
    with open(bpath) as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": "tiny", "file": path,
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name + ".docqa", "config": name,
                               "traffic": "tiny-docqa", "chips": 1,
                               "why": "a configuration added by files"})
    for m in bench["end_to_end"]:
        if m["name"] == "gen_tok_s":
            m["workloads"].append(name + ".docqa")
    with open(bpath, "w") as f:
        json.dump(bench, f)
    return path


def test_new_family_is_files_alone(tiny_root):
    """A family written as one new file, a configuration naming it and a
    cell on it: the run takes its weights, its reference and its
    roofline counts from that file, and no harness file changes."""
    import torch

    from kvbench.families import llama
    with open(os.path.join(tiny_root, "kvbench", "families",
                           "tinywrap.py"), "w") as f:
        f.write(TINYWRAP)
    _add_config(tiny_root, "tiny-wrap", "tiny-gqa", family="tinywrap")
    seed = 2 ** 31 + 99
    res, rec = run.run_cell(tiny_root, "tiny-wrap.docqa", seed, 1.0, False,
                            "cpu")
    assert res["correct"], res["check"]
    fam = rec.family
    assert fam.__file__.startswith(tiny_root)
    assert fam.CALLS["make_params"] == 1
    assert fam.CALLS["logits"] >= 1 and fam.CALLS["forward"] >= 1
    assert set(res["metrics"]) == {"gen_tok_s", "setup_s"}

    def same(a, b):
        a, b = llama.program_params(a), llama.program_params(b)
        return all(torch.equal(a[k], b[k]) for k in ("embed", "lm_head")) \
            and all(torch.equal(x[k], y[k]) for x, y in zip(a["layers"],
                                                            b["layers"])
                    for k in x)
    made = fam.MADE[0]
    assert same(made, llama.make_params(rec.cfg, seed + fam.OFFSET, "cpu"))
    assert not same(made, llama.make_params(rec.cfg, seed, "cpu"))


@pytest.mark.parametrize("family", [None, "nosuch", "partial"])
def test_config_without_a_family_fails_at_load(tiny_root, family):
    """No default: a configuration that names no family, or one with no
    file, stops the run at load and names the file it looked for; a
    family file without the whole interface names what it lacks."""
    path = _add_config(tiny_root, "tiny-lost", "tiny-gqa", family=family)
    fpath = os.path.join(tiny_root, "kvbench", "families", f"{family}.py")
    if family == "partial":
        with open(fpath, "w") as f:
            f.write("from kvbench.families.llama import config, reference\n")
    with pytest.raises(SystemExit) as e:
        run.load_cell(tiny_root, "tiny-lost.docqa", 1, 1.0, False, "cpu")
    msg = str(e.value)
    if family is None:
        assert path in msg and "kvbench/families/<name>.py" in msg, msg
    elif family == "nosuch":
        assert path in msg and fpath in msg, msg
    else:
        assert msg == f"{fpath} lacks make_params, refill, program_params, " \
            "roofline, roofline.layer_params, roofline.weight_bytes, " \
            "roofline.forward, roofline.decode_attention, " \
            "roofline.decode_layers", msg


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
