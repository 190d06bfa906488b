"""A tiny copy of the benchmark for the CPU tests: the harness's files in
a temporary root, with two small configurations and traffic files beside
the real ones, and a BENCHMARK.json that names them."""

from __future__ import annotations

import copy
import json
import os
import shutil

KVBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(KVBENCH)

# wide enough for 2-bit codes and a vocabulary with near ties, small
# enough for the CPU; make_root(deep=True) keeps each real configuration's
# depth, where the fp8 control's error builds up over the layers as it
# does at full size
MODEL = {"vocab_size": 4096, "hidden_size": 256, "intermediate_size": 512,
         "num_layers": 8, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 32, "max_position_embeddings": 1024}
DOCQA = {"doc_tokens": 350, "questions": 4, "question_tokens": 16,
         "new_tokens": 40, "max_seq_len": 512}
CHAT = {"batcher": {"num_slots": 4, "max_seq_len": 512,
                    "prompt_buckets": [32, 64, 128, 256, 512]},
        "rate": 2.0, "preroll_s": 0.5, "drain_s": 60.0,
        "prompt": {"min": 20, "max": 200}, "output": {"min": 16, "max": 64},
        "greedy_share": 0.75, "profile_steps": 4,
        "check": {"requests": 12}}
# at width 256 the bf16 keys and values a decode step writes read 0.05
# (8 layers) to 0.10 (32 layers) from the f32 reference's, where the real
# widths read 0.03: the tiny cells hold them to a limit of their own
TINY_LIMITS = {"window_kv": 0.15}
CELLS = {"tiny-gqa.docqa": ("tiny-gqa", "tiny-docqa"),
         "tiny-mha.chat": ("tiny-mha", "tiny-chat")}


def make_root(tmp: str, deep: bool = False) -> str:
    """A root holding BENCHMARK.json (the repo's, plus the tiny cells) and
    a copy of kvbench/ with the tiny files added; deep: the tiny
    configurations at their real configuration's number of layers."""
    dst = os.path.join(tmp, "kvbench")
    shutil.copytree(KVBENCH, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = {w["config"]: w for w in bench["workloads"]}
    for cfg_name, base in (("tiny-gqa", "mistral-7b-v0.2"),
                           ("tiny-mha", "deepseek-llm-7b")):
        with open(os.path.join(KVBENCH, "configs", base + ".json")) as f:
            conf = json.load(f)
        layers = conf["model"]["num_layers"] if deep else MODEL["num_layers"]
        conf["model"] = dict(MODEL, num_kv_heads=2 if "gqa" in cfg_name
                             else 4, num_layers=layers)
        path = f"kvbench/configs/{cfg_name}.json"
        with open(os.path.join(tmp, path), "w") as f:
            json.dump(conf, f)
        bench["configs"].append({"name": cfg_name, "source": "tiny",
                                 "file": path, "reduced": [], "why": "test"})
    for mix, base, over in (("tiny-docqa", "docqa-12k", DOCQA),
                            ("tiny-chat", "chat-serve", CHAT)):
        with open(os.path.join(KVBENCH, "traffic", base + ".json")) as f:
            traffic = json.load(f)
        limits = {k: TINY_LIMITS.get(k, v)
                  for k, v in traffic["check"]["limits"].items()}
        traffic.update(copy.deepcopy(over))
        # the real cell's limits, with as many answers compared as a tiny
        # window serves
        traffic["check"] = dict(traffic["check"], limits=limits)
        with open(os.path.join(dst, "traffic", mix + ".json"), "w") as f:
            json.dump(traffic, f)
    for cell, (cfg_name, mix) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg_name,
                                   "traffic": mix, "chips": 1, "why": "test"})
        like = real["mistral-7b-v0.2" if "gqa" in cfg_name
                    else "deepseek-llm-7b"]["name"]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
