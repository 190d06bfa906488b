"""Evaluation suite: LongBench predict/score and metrics, port of
`kivi_tpu/evalsuite` (engine-agnostic; `run_longbench` drives the
port's Engine).
"""

from kivi_tpu_torch.evalsuite import metrics
from kivi_tpu_torch.evalsuite.longbench import (
    DATASET2MAXLEN,
    DATASET2METRIC,
    DATASET2PROMPT,
    REFERENCE_TASKS,
    build_chat,
    load_jsonl,
    middle_truncate,
    predict_task,
    score_dir,
    scorer,
    scorer_e,
)

__all__ = [
    "metrics", "DATASET2MAXLEN", "DATASET2METRIC", "DATASET2PROMPT",
    "REFERENCE_TASKS", "build_chat", "load_jsonl", "middle_truncate",
    "predict_task", "score_dir", "scorer", "scorer_e",
]
