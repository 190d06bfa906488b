"""LongBench metric implementations: the port's own copy of
`kivi_tpu/evalsuite/metrics.py` (the behavioural spec is the reference
harness's `metrics.py`), pure Python, held equal to the JAX package's by
tests/test_torch_evalsuite.py.

Differences from the reference, forced by the no-new-deps environment:
  * rouge-l comes from our own LCS F-measure instead of the `rouge` pip
    package (same definition; the pip package additionally applies its
    own tokenizer quirks).
  * code similarity uses difflib's ratio instead of fuzzywuzzy's
    Levenshtein `fuzz.ratio` (both are normalized edit-similarity in
    [0, 1]; values track within a few points).
  * Chinese metrics degrade to character-level tokenization when jieba
    is unavailable.
"""

from __future__ import annotations

import difflib
import re
import string
from collections import Counter
from typing import List

try:  # pragma: no cover - optional dependency
    import jieba  # type: ignore

    def _zh_tokens(s: str) -> List[str]:
        return list(jieba.cut(s, cut_all=False))
except Exception:  # jieba not installed: character tokens
    def _zh_tokens(s: str) -> List[str]:
        return list(s)


# -- normalization (the reference's metrics.py:13-46) ----------------------

def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation, drop english articles, squeeze spaces."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


_CN_PUNCT = (
    "！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃》「」"
    "『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏."
)


def normalize_zh_answer(s: str) -> str:
    s = s.lower()
    punct = set(string.punctuation + _CN_PUNCT)
    s = "".join(ch for ch in s if ch not in punct)
    return "".join(s.split())


# -- token-level F1 (the reference's metrics.py:135-160) -------------------

def _f1(pred_tokens, gt_tokens) -> float:
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0 or not pred_tokens or not gt_tokens:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kw) -> float:
    return _f1(normalize_answer(prediction).split(),
               normalize_answer(ground_truth).split())


def qa_f1_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    pt = [normalize_zh_answer(t) for t in _zh_tokens(prediction)]
    gt = [normalize_zh_answer(t) for t in _zh_tokens(ground_truth)]
    return _f1([t for t in pt if t], [t for t in gt if t])


# -- rouge-l (the reference's metrics.py:117-132, via the `rouge` package) -

def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_score(prediction: str, ground_truth: str, **kw) -> float:
    """ROUGE-L F-measure over whitespace tokens."""
    p = prediction.split()
    g = ground_truth.split()
    lcs = _lcs_len(p, g)
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(g)
    return 2 * prec * rec / (prec + rec)


def rouge_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    return rouge_score(" ".join(_zh_tokens(prediction)),
                       " ".join(_zh_tokens(ground_truth)))


# -- task-specific scores (the reference's metrics.py:47-115) --------------

def count_score(prediction: str, ground_truth: str, **kw) -> float:
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return right / len(numbers)


def _retrieval(prediction: str, ground_truth: str, pattern: str) -> float:
    matches = re.findall(pattern, ground_truth)
    if not matches:
        return 0.0
    gt_id = matches[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if str(n) == str(gt_id)) / len(numbers)


def retrieval_score(prediction: str, ground_truth: str, **kw) -> float:
    return _retrieval(prediction, ground_truth, r"Paragraph (\d+)")


def retrieval_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    return _retrieval(prediction, ground_truth, r"段落(\d+)")


def code_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    """Similarity of the first non-comment line of the prediction."""
    line = ""
    for cand in prediction.lstrip("\n").split("\n"):
        if "`" not in cand and "#" not in cand and "//" not in cand:
            line = cand
            break
    return difflib.SequenceMatcher(None, line, ground_truth).ratio()


def classification_score(prediction: str, ground_truth: str, **kw) -> float:
    """Credit 1/|matched classes| when the gold class is among the class
    names found verbatim in the prediction; drop matches that are proper
    substrings of the gold label (the reference's metrics.py:89-115)."""
    all_classes = kw.get("all_classes") or []
    matches = [c for c in all_classes if c in prediction]
    matches = [m for m in matches
               if not (m in ground_truth and m != ground_truth)]
    if ground_truth in matches:
        return 1.0 / len(matches)
    return 0.0
