"""The port's eval suite (kivi_tpu_torch.evalsuite) against the JAX
package's (kivi_tpu.evalsuite): the metrics, the task tables and the
predict / score plumbing are pure Python copies and must agree exactly;
the synthetic K/V draw from a torch.Generator (the streams cannot equal
jax.random's), so they are held to the structure the JAX module
documents instead.

Tolerance: none for the metrics and plumbing (equal floats, equal
records, equal result.json); the synthetic tensors' structure by the
ratios stated in each test.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kivi_tpu.evalsuite import longbench as JL
from kivi_tpu.evalsuite import metrics as JM
from kivi_tpu.evalsuite import synth as JS
from kivi_tpu_torch import evalsuite as TE
from kivi_tpu_torch.evalsuite import longbench as TL
from kivi_tpu_torch.evalsuite import metrics as TM
from kivi_tpu_torch.evalsuite import synth as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLASSES = ["location", "number", "entity", "description", "loc"]
# (prediction, ground truth): English, Chinese, code, counts, retrieval,
# classes, empty and degenerate strings
PAIRS = [
    ("Paris", "paris"),
    ("the city of Paris", "Paris, the city"),
    ("London", "Paris"),
    ("The  Quick, Brown fox!", "quick brown fox jumps"),
    ("a b c d", "a c"),
    ("北京是中国的首都。", "北京"),
    ("他在段落3里说了", "段落3"),
    ("答案是段落12和段落3", "段落12"),
    ("return x + 1", "return x + 1"),
    ("# comment\n// more\nreturn x + 1\nprint(x)", "return x+1"),
    ("```python\ndef f(x):", "def f(x):"),
    ("there are 7 paragraphs", "7"),
    ("maybe 6 or 7", "7"),
    ("no digits here", "7"),
    ("Paragraph 12", "Paragraph 12"),
    ("it is 12 or 3", "Paragraph 12"),
    ("the answer is location", "location"),
    ("location or number", "location"),
    ("loc", "location"),
    ("\n\nfirst line\nsecond line", "first line"),
    ("", "anything"),
    ("something", ""),
]


class ToyTok:
    """tests/test_evalsuite.py's whitespace tokenizer."""

    def encode(self, s):
        return s.split()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(ids) + " "


@pytest.mark.parametrize("task", sorted(JL.DATASET2METRIC))
def test_metric_matches_jax(task):
    tm, jm = TL.DATASET2METRIC[task], JL.DATASET2METRIC[task]
    assert tm.__name__ == jm.__name__
    for pred, gt in PAIRS:
        got = tm(pred, gt, all_classes=CLASSES)
        want = jm(pred, gt, all_classes=CLASSES)
        assert got == want, (task, pred, gt, got, want)


def test_normalizers_and_helpers_match_jax():
    for pred, gt in PAIRS:
        for s in (pred, gt):
            assert TM.normalize_answer(s) == JM.normalize_answer(s)
            assert TM.normalize_zh_answer(s) == JM.normalize_zh_answer(s)
            assert TM._zh_tokens(s) == JM._zh_tokens(s)
        assert TM._lcs_len(pred.split(), gt.split()) == \
            JM._lcs_len(pred.split(), gt.split())


def test_tables_match_jax():
    assert TL.DATASET2PROMPT == JL.DATASET2PROMPT
    assert TL.DATASET2MAXLEN == JL.DATASET2MAXLEN
    assert {k: f.__name__ for k, f in TL.DATASET2METRIC.items()} == \
        {k: f.__name__ for k, f in JL.DATASET2METRIC.items()}
    assert TL.FIRST_LINE_TASKS == JL.FIRST_LINE_TASKS
    assert TL.NO_CHAT_TASKS == JL.NO_CHAT_TASKS
    assert TL.REFERENCE_TASKS == JL.REFERENCE_TASKS
    import kivi_tpu.evalsuite as JE
    assert TE.__all__ == JE.__all__


@pytest.mark.parametrize("max_len", [1, 2, 10, 99, 100, 1000])
def test_middle_truncate_matches_jax(max_len):
    prompt = " ".join(str(i) for i in range(100))
    assert TL.middle_truncate(prompt, ToyTok(), max_len) == \
        JL.middle_truncate(prompt, ToyTok(), max_len)


@pytest.mark.parametrize("name", ["", "longchat-7b", "vicuna", "llama-3-8b",
                                  "Meta-Llama3", "llama2-7b-chat",
                                  "Llama-2-13b", "mistral-7b", "gpt"])
def test_build_chat_matches_jax(name):
    assert TL.build_chat("Q?", name) == JL.build_chat("Q?", name)


def _records(seed):
    """LongBench-format records for every task, lengths over the three
    LongBench-E buckets."""
    rng = np.random.default_rng(seed)
    words = "alpha beta gamma delta location number 7 12 Paragraph".split()
    out = []
    for i in range(6):
        ctx = " ".join(rng.choice(words, size=int(rng.integers(5, 200))))
        out.append({"input": f"question {i}", "context": ctx,
                    "answers": [str(rng.choice(words)), "7"],
                    "all_classes": CLASSES,
                    "length": int(rng.choice([100, 5000, 9000]))})
    return out


def _fake_generate(prompt, max_new):
    # a deterministic function of the prompt, over the metrics' cases
    n = len(prompt.split())
    return ["7", "Paragraph 12", "location", "alpha beta",
            "\nnumber\nlocation"][n % 5] + f" {max_new}"


@pytest.mark.parametrize("task", ["hotpotqa", "samsum", "trec",
                                  "passage_count", "passage_retrieval_en",
                                  "lcc", "gov_report"])
def test_predict_and_score_match_jax(task, tmp_path):
    data = _records(sum(map(ord, task)))
    kw = dict(max_prompt_len=64, model_name="llama2-7b")
    got = TL.predict_task(task, data, _fake_generate, ToyTok(),
                          out_path=str(tmp_path / "t" / f"{task}.jsonl"),
                          **kw)
    want = JL.predict_task(task, data, _fake_generate, ToyTok(),
                           out_path=str(tmp_path / "j" / f"{task}.jsonl"),
                           **kw)
    assert got == want
    assert TL.load_jsonl(str(tmp_path / "t" / f"{task}.jsonl")) == want
    assert TL.scorer(task, got) == JL.scorer(task, want)
    assert TL.scorer_e(task, got) == JL.scorer_e(task, want)
    for use_e in (False, True):
        assert TL.score_dir(str(tmp_path / "t"), use_e) == \
            JL.score_dir(str(tmp_path / "j"), use_e)
        with open(tmp_path / "t" / "result.json") as f, \
                open(tmp_path / "j" / "result.json") as g:
            assert f.read() == g.read()


def test_scorers_on_empty_records_match_jax():
    assert TL.scorer("hotpotqa", []) == JL.scorer("hotpotqa", []) == 0.0
    assert TL.scorer_e("hotpotqa", []) == JL.scorer_e("hotpotqa", [])


# -- synth: the documented structure ----------------------------------------

@pytest.mark.parametrize("D,frac", [(128, 0.03), (64, 0.05), (16, 0.001),
                                    (128, 0.1)])
def test_outlier_profile_structure(D, frac):
    import jax
    g = torch.Generator().manual_seed(D)
    prof = TS.outlier_profile(g, D, frac, 12.0)
    want = JS.outlier_profile(jax.random.PRNGKey(0), D, frac, 12.0)
    assert prof.shape == tuple(want.shape) == (D,)
    assert prof.dtype == torch.float32 and str(want.dtype) == "float32"
    assert bool((prof > 0).all())
    n_out = max(1, int(round(D * frac)))
    # the profile over its lognormal body (the first draw of each
    # stream, replayed): exactly n_out distinct channels boosted by
    # 12 exp(0.3 N) (in (2, 72) for |N| < 6), the rest untouched
    body = torch.exp(0.4 * torch.randn(D, generator=torch.Generator(
    ).manual_seed(D)))
    k1 = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    jbody = np.exp(0.4 * np.asarray(jax.random.normal(k1, (D,))))
    for ratio in ((prof / body).numpy(), np.asarray(want) / jbody):
        boosted = np.abs(ratio - 1) > 1e-6
        assert boosted.sum() == n_out
        assert ((ratio[boosted] > 2) & (ratio[boosted] < 72)).all()


def test_structured_kv_structure():
    import jax
    B, H, T, D = 2, 4, 512, 128
    k, v = TS.structured_kv(torch.Generator().manual_seed(3), B, H, T, D)
    jk, jv = JS.structured_kv(jax.random.PRNGKey(3), B, H, T, D)
    assert k.shape == v.shape == tuple(jk.shape) == tuple(jv.shape)
    assert k.dtype == v.dtype == torch.float32
    assert str(jk.dtype) == str(jv.dtype) == "float32"
    for kk, vv in ((k.numpy(), v.numpy()), (np.asarray(jk), np.asarray(jv))):
        # K: a few channels dominate the per-channel magnitude
        mag = np.abs(kk).mean(axis=(0, 2))                  # (H, D)
        n_out = int(round(D * 0.03))
        for h in range(H):
            s = np.sort(mag[h])[::-1]
            assert s[n_out - 1] > 3.0 * np.median(s)
        # K's channel mean persists across tokens: the first and second
        # halves' per-channel means agree, and they are far from zero
        m1 = kk[:, :, :T // 2].mean(axis=2)
        m2 = kk[:, :, T // 2:].mean(axis=2)
        spread = kk.std(axis=2)
        assert np.abs(m1 - m2).max() < 0.5 * np.abs(m1).max()
        assert np.corrcoef(m1.ravel(), m2.ravel())[0, 1] > 0.99
        assert (np.abs(m1) / spread).mean() > 1.0
        # V: no channel structure (per-channel std all near 1, means 0)
        vs = vv.std(axis=(0, 2))
        assert np.abs(vs - 1).max() < 0.15
        assert np.abs(vv.mean(axis=(0, 2))).max() < 0.15


def test_evalsuite_import_loads_no_jax():
    code = ("import sys; import kivi_tpu_torch.evalsuite, "
            "kivi_tpu_torch.evalsuite.run_longbench, "
            "kivi_tpu_torch.evalsuite.synth; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'kivi_tpu' or "
            "m.startswith('kivi_tpu.') or m == 'transformers']; "
            "assert not bad, bad")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_score_cli_runs_without_transformers(tmp_path):
    """`run_longbench score` prints the result.json of score_dir."""
    TL.predict_task("hotpotqa", _records(1), _fake_generate, ToyTok(), 64,
                    out_path=str(tmp_path / "hotpotqa.jsonl"))
    code = ("import sys; sys.modules['transformers'] = None; "
            "from kivi_tpu_torch.evalsuite import run_longbench; "
            f"run_longbench.main(['score', '--pred-dir', {str(tmp_path)!r}])")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(tmp_path / "result.json") as f:
        want = json.load(f)
    assert json.loads(r.stdout) == want == \
        JL.score_dir(str(tmp_path), False)
