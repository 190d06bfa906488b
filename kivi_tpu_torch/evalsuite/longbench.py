"""LongBench predict + score harness: the port's own copy of
`kivi_tpu/evalsuite/longbench.py` (the reference harness's
`pred_long_bench.py` and `eval_long_bench.py`): per-task prompt
templates and generation caps, middle-truncation of over-long prompts,
greedy decode, jsonl prediction dumps, and metric scoring with
max-over-ground-truths plus the length-bucketed "-e" variant.

The harness is engine-agnostic: `predict_task` takes a
`generate_fn(prompt, max_new_tokens) -> str` and a tokenizer exposing
`encode`/`decode` (an HF tokenizer works; tests use a toy tokenizer).
Datasets are supplied as iterables of LongBench-format dicts
(`{"input", "context", "answers", "all_classes", "length"}`) — in an
air-gapped environment load them from local jsonl via `load_jsonl`.
Pure Python and numpy, held equal to the JAX package's module by
tests/test_torch_evalsuite.py.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from kivi_tpu_torch.evalsuite import metrics as M

# -- task tables -------------------------------------------------------------
# Prompt templates and generation caps per LongBench task (the public
# THUDM/LongBench configuration, as used by the reference's
# `config/dataset2prompt.json` / `config/dataset2maxlen.json`).

DATASET2PROMPT: Dict[str, str] = {
    "narrativeqa": "You are given a story, which can be either a novel or a movie script, and a question. Answer the question asconcisely as you can, using a single phrase if possible. Do not provide any explanation.\n\nStory: {context}\n\nNow, answer the question based on the story asconcisely as you can, using a single phrase if possible. Do not provide any explanation.\n\nQuestion: {input}\n\nAnswer:",
    "qasper": "You are given a scientific article and a question. Answer the question as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write \"unanswerable\". If the question is a yes/no question, answer \"yes\", \"no\", or \"unanswerable\". Do not provide any explanation.\n\nArticle: {context}\n\n Answer the question based on the above article as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write \"unanswerable\". If the question is a yes/no question, answer \"yes\", \"no\", or \"unanswerable\". Do not provide any explanation.\n\nQuestion: {input}\n\nAnswer:",
    "multifieldqa_en": "Read the following text and answer briefly.\n\n{context}\n\nNow, answer the following question based on the above text, only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "hotpotqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "2wikimqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "musique": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "gov_report": "You are given a report by a government agency. Write a one-page summary of the report.\n\nReport:\n{context}\n\nNow, write a one-page summary of the report.\n\nSummary:",
    "qmsum": "You are given a meeting transcript and a query containing a question or instruction. Answer the query in one or more sentences.\n\nTranscript:\n{context}\n\nNow, answer the query based on the above meeting transcript in one or more sentences.\n\nQuery: {input}\nAnswer:",
    "multi_news": "You are given several news passages. Write a one-page summary of all news. \n\nNews:\n{context}\n\nNow, write a one-page summary of all the news.\n\nSummary:",
    "trec": "Please determine the type of the question below. Here are some examples of questions.\n\n{context}\n{input}",
    "triviaqa": "Answer the question based on the given passage. Only give me the answer and do not output any other words. The following are some examples.\n\n{context}\n\n{input}",
    "samsum": "Summarize the dialogue into a few short sentences. The following are some examples.\n\n{context}\n\n{input}",
    "passage_count": "There are some paragraphs below sourced from Wikipedia. Some of them may be duplicates. Please carefully read these paragraphs and determine how many unique paragraphs there are after removing duplicates. In other words, how many non-repeating paragraphs are there in total?\n\n{context}\n\nPlease enter the final count of unique paragraphs after removing duplicates. The output format should only contain the number, such as 1, 2, 3, and so on.\n\nThe final answer is: ",
    "passage_retrieval_en": "Here are 30 paragraphs from Wikipedia, along with an abstract. Please determine which paragraph the abstract is from.\n\n{context}\n\nThe following is an abstract.\n\n{input}\n\nPlease enter the number of the paragraph that the abstract is from. The answer format must be like \"Paragraph 1\", \"Paragraph 2\", etc.\n\nThe answer is: ",
    "lcc": "Please complete the code given below. \n{context}Next line of code:\n",
    "repobench-p": "Please complete the code given below. \n{context}{input}Next line of code:\n",
}

DATASET2MAXLEN: Dict[str, int] = {
    "narrativeqa": 128, "qasper": 128, "multifieldqa_en": 64,
    "hotpotqa": 32, "2wikimqa": 32, "musique": 32, "gov_report": 512,
    "qmsum": 512, "multi_news": 512, "trec": 64, "triviaqa": 32,
    "samsum": 128, "passage_count": 32, "passage_retrieval_en": 32,
    "lcc": 64, "repobench-p": 64,
}

# reference eval_long_bench.py:18-40
DATASET2METRIC: Dict[str, Callable] = {
    "narrativeqa": M.qa_f1_score,
    "qasper": M.qa_f1_score,
    "multifieldqa_en": M.qa_f1_score,
    "multifieldqa_zh": M.qa_f1_zh_score,
    "hotpotqa": M.qa_f1_score,
    "2wikimqa": M.qa_f1_score,
    "musique": M.qa_f1_score,
    "dureader": M.rouge_zh_score,
    "gov_report": M.rouge_score,
    "qmsum": M.rouge_score,
    "multi_news": M.rouge_score,
    "vcsum": M.rouge_zh_score,
    "trec": M.classification_score,
    "triviaqa": M.qa_f1_score,
    "samsum": M.rouge_score,
    "lsht": M.classification_score,
    "passage_retrieval_en": M.retrieval_score,
    "passage_count": M.count_score,
    "passage_retrieval_zh": M.retrieval_zh_score,
    "lcc": M.code_sim_score,
    "repobench-p": M.code_sim_score,
}

# Tasks where only the first line of the prediction is scored
# (reference eval_long_bench.py:84-85) and where no chat template is
# applied at predict time (pred_long_bench.py:62-64).
FIRST_LINE_TASKS = ("trec", "triviaqa", "samsum", "lsht")
NO_CHAT_TASKS = ("trec", "triviaqa", "samsum", "lsht",
                 "lcc", "repobench-p")

# The 15 tasks of the reference's published tables (BASELINE.md).
REFERENCE_TASKS = [
    "narrativeqa", "qasper", "multifieldqa_en", "hotpotqa", "2wikimqa",
    "musique", "gov_report", "qmsum", "multi_news", "lcc", "repobench-p",
    "triviaqa", "samsum", "trec", "passage_retrieval_en",
]


# -- predict ------------------------------------------------------------------

def middle_truncate(prompt: str, tokenizer, max_len: int) -> str:
    """Keep the head and tail halves when the tokenized prompt exceeds
    max_len (reference pred_long_bench.py:56-58 — truncating the middle
    preserves both instructions and the question)."""
    ids = tokenizer.encode(prompt)
    if len(ids) <= max_len:
        return prompt
    half = max_len // 2
    return (tokenizer.decode(ids[:half], skip_special_tokens=True)
            + tokenizer.decode(ids[-half:], skip_special_tokens=True))


def build_chat(prompt: str, model_name: str) -> str:
    """Chat-wrap per model family (reference pred_long_bench.py:16-39)."""
    name = model_name.lower()
    if "longchat" in name or "vicuna" in name:
        return (f"A chat between a curious user and an artificial "
                f"intelligence assistant. The assistant gives helpful, "
                f"detailed, and polite answers to the user's questions. "
                f"USER: {prompt} ASSISTANT:")
    if "llama-3" in name or "llama3" in name:
        return (f"<|begin_of_text|><|start_header_id|>user<|end_header_id|>"
                f"\n\n{prompt}<|eot_id|><|start_header_id|>assistant"
                f"<|end_header_id|>\n\n")
    if "llama2" in name or "llama-2" in name:
        return f"[INST]{prompt}[/INST]"
    if "mistral" in name:
        return f"<s>[INST] {prompt} [/INST]"
    return prompt


def predict_task(task: str, data: Iterable[dict], generate_fn,
                 tokenizer, max_prompt_len: int, model_name: str = "",
                 out_path: Optional[str] = None,
                 progress: bool = False) -> List[dict]:
    """Run one LongBench task; returns (and optionally writes) the
    prediction records (reference pred_long_bench.py:48-84)."""
    tmpl = DATASET2PROMPT[task]
    max_gen = DATASET2MAXLEN[task]
    out = []
    for i, ex in enumerate(data):
        prompt = tmpl.format(**ex)
        prompt = middle_truncate(prompt, tokenizer, max_prompt_len)
        if task not in NO_CHAT_TASKS:
            prompt = build_chat(prompt, model_name)
        pred = generate_fn(prompt, max_gen)
        out.append({
            "pred": pred,
            "answers": ex.get("answers", []),
            "all_classes": ex.get("all_classes", []),
            "length": ex.get("length", 0),
        })
        if progress:
            print(f"[{task}] {i + 1} examples", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            for rec in out:
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
    return out


# -- score --------------------------------------------------------------------

def _one_score(task: str, prediction: str, ground_truths, all_classes):
    if task in FIRST_LINE_TASKS:
        prediction = prediction.lstrip("\n").split("\n")[0]
    return max((DATASET2METRIC[task](prediction, gt,
                                     all_classes=all_classes)
                for gt in ground_truths), default=0.0)


def scorer(task: str, records: List[dict]) -> float:
    """Mean score * 100 (reference eval_long_bench.py:66-75)."""
    if not records:
        return 0.0
    total = sum(_one_score(task, r["pred"], r["answers"],
                           r.get("all_classes")) for r in records)
    return round(100 * total / len(records), 2)


def scorer_e(task: str, records: List[dict]) -> Dict[str, float]:
    """Length-bucketed LongBench-E scoring (eval_long_bench.py:48-64)."""
    buckets = {"0-4k": [], "4-8k": [], "8k+": []}
    for r in records:
        s = _one_score(task, r["pred"], r["answers"], r.get("all_classes"))
        length = r.get("length", 0)
        key = "0-4k" if length < 4000 else ("4-8k" if length < 8000
                                            else "8k+")
        buckets[key].append(s)
    return {k: round(100 * float(np.mean(v)), 2) if v else 0.0
            for k, v in buckets.items()}


def score_dir(pred_dir: str, use_e: bool = False) -> Dict[str, object]:
    """Score every <task>.jsonl in a directory, write result.json
    (reference eval_long_bench.py:77-109)."""
    results = {}
    for fname in sorted(os.listdir(pred_dir)):
        if not fname.endswith(".jsonl"):
            continue
        task = fname[:-6]
        if task not in DATASET2METRIC:
            continue
        records = load_jsonl(os.path.join(pred_dir, fname))
        results[task] = (scorer_e(task, records) if use_e
                         else scorer(task, records))
    with open(os.path.join(pred_dir, "result.json"), "w") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    return results


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
