"""Jobs of many questions over one long document, through the engine:
`Engine.prefill_prefix` of the document (one-shot), then
`Engine.generate(questions, new_tokens, prefix=snapshot)` over a batch of
questions, greedy.  Jobs run back to back; each has its own document and
questions, drawn from the seed and the job's index.

Traffic parameters: doc_tokens, questions (the engine's batch),
question_tokens, new_tokens, max_seq_len; check.rows (answers compared
with the reference) and check.limits.

Counts: a `job` span per job (with its `engine.prefill_prefix` span, and
in a traced run an `engine.decode` span from an instance wrapper of
`Engine.decode`), the job's tokens, and the least time of its forwards.
The wrapper keeps the caches `Engine.decode` returns: after the window
the check reads the windows the last job's decode steps left in them.
A traced run profiles one more job of the same kind right after the
window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kivi_tpu_torch.serving.engine import Engine
from kvbench import roofline, trace


class State:
    def __init__(self, cell, params):
        t = cell.traffic
        self.eng = Engine(cell.cfg, cell.qcfg, params,
                          max_seq_len=t["max_seq_len"],
                          batch_size=t["questions"], device=cell.device)
        self.outputs: dict = {}
        self.last = None        # (job, tokens) of the last job run
        self.caches = None      # the caches its decode left


def inputs(cell, j: int):
    """Job j's document (T0,) and questions (B, Tq), int64; j = -1 is the
    warm-up's."""
    t = cell.traffic
    rng = np.random.default_rng([int(cell.seed), j + 1])
    V = cell.cfg.vocab_size
    doc = rng.integers(0, V, t["doc_tokens"], dtype=np.int64)
    qs = rng.integers(0, V, (t["questions"], t["question_tokens"]),
                      dtype=np.int64)
    return doc, qs


def _job(st: State, cell, j: int):
    t = cell.traffic
    doc, qs = inputs(cell, j)
    dev = cell.device
    with cell.spans.span("job", index=j) as s:
        with cell.spans.span("engine.prefill_prefix"):
            snap = st.eng.prefill_prefix(torch.from_numpy(doc).to(dev))
        out = st.eng.generate(torch.from_numpy(qs).to(dev),
                              t["new_tokens"], prefix=snap)
        out = out.cpu().numpy()
    st.last = (j, out)
    return s, out


def setup(cell, params) -> State:
    st = State(cell, params)
    _job(st, cell, -1)       # every kernel built, the decode graph captured
    return st


def _decode_rows(cell, k: int):
    t, q = cell.traffic, cell.qcfg
    T = t["doc_tokens"] + t["question_tokens"]
    return [cell.family.reference.decode_counts(
        T, k, q.residual_length, q.value_flush)] * t["questions"]


def _shared(cell):
    q, T0 = cell.qcfg, cell.traffic["doc_tokens"]
    W = q.residual_length
    return (T0 // W) * W, cell.family.reference.quantized_values_at_ingest(
        T0, W, q.value_flush)


def job_bound_s(cell) -> float:
    """The least time of one job's forwards: the document's prefill, the
    questions' extend over it, and new_tokens - 1 decode steps."""
    cfg, q, t = cell.cfg, cell.qcfg, cell.traffic
    T0, B, Tq = t["doc_tokens"], t["questions"], t["question_tokens"]
    forward = cell.family.roofline.forward
    shared = _shared(cell)
    hist = (shared[0], T0 - shared[0], shared[1], T0 - shared[1])
    total = roofline.bound_s(*forward(cfg, q, 1, T0, logit_rows=1))
    total += roofline.bound_s(*forward(
        cfg, q, B, Tq, [hist] * B, shared, logit_rows=B))
    for k in range(t["new_tokens"] - 1):
        total += roofline.bound_s(*forward(
            cfg, q, B, 1, _decode_rows(cell, k), shared, logit_rows=B,
            causal_new=False))
    return total


def window(st: State, cell, rec) -> None:
    t = cell.traffic
    _wrap_decode(st, cell)
    per_job = t["questions"] * t["new_tokens"]
    bound = job_bound_s(cell)
    rec.t0 = t0 = time.perf_counter()
    j = 0
    while time.perf_counter() - t0 < cell.seconds:
        s, out = _job(st, cell, j)
        st.outputs[j] = out
        rec.jobs.append({"start": s.start, "end": s.end, "tokens": per_job})
        rec.forwards.append(bound)
        j += 1
    rec.window_s = rec.jobs[-1]["end"] - t0
    rec.attempted = j * t["questions"]
    V, want = cell.cfg.vocab_size, (t["questions"], t["new_tokens"])
    for o in st.outputs.values():
        rec.failed += (int(((o < 0) | (o >= V)).any(1).sum())
                       if o.shape == want else want[0])
    if cell.trace:
        # one more job, after the window, under the profiler: its start,
        # stop and reading stay out of the window's time
        counters = {"decode_rows": [(_decode_rows(cell, k), _shared(cell))
                                    for k in range(t["new_tokens"] - 1)]}
        with trace.profiled(cell.spans, cell.device, counters) as prof:
            _job(st, cell, j)
        rec.profile = prof[0] if prof else None


def _wrap_decode(st: State, cell) -> None:
    """An instance wrapper of `Engine.decode` that keeps the caches it
    returns (the check reads their windows after the window); in a traced
    run it also syncs at entry and records an `engine.decode` span."""
    orig = st.eng.decode

    def decode(*a, **kw):
        if cell.trace:
            trace.sync(cell.device)
            with cell.spans.span("engine.decode", steps=kw["steps"]):
                out = orig(*a, **kw)
        else:
            out = orig(*a, **kw)
        st.caches = out[1]
        return out

    st.eng.decode = decode


def check_items(st: State, cell, rec) -> list:
    """[(Group, first, tokens, kind)]: check.rows answers drawn from the
    seed of a job drawn from the seed, each answer's logits from index
    `first` on compared with its greedy tokens (kind None); and the same
    rows of the last job the engine ran, the windows of every layer's
    cache as its decode steps left them (kind ("state", windows))."""
    t, q = cell.traffic, cell.qcfg
    rng = np.random.default_rng([int(cell.seed), 0, 1])
    j = int(rng.integers(len(st.outputs)))
    rows = np.sort(rng.choice(t["questions"], t["check"]["rows"],
                              replace=False))
    items = [_answers(cell, j, rows, st.outputs[j]) + (None,)]
    last, out = st.last
    if st.caches is not None:
        r = torch.from_numpy(rows).to(st.caches[0].k_win.device)
        wins = {"counts": [(c.n_k_quant, c.n_k_win, c.n_v_quant, c.n_v_win)
                           for c in st.caches],
                "k": [c.k_win[r, :, :int(c.n_k_win)].float().cpu()
                      for c in st.caches],
                "v": [c.v_win[r, :, :int(c.n_v_win)].float().cpu()
                      for c in st.caches]}
        items.append(_answers(cell, last, rows, out) + (("state", wins),))
    return items


def _answers(cell, j: int, rows, out) -> tuple:
    """(Group, first, tokens) of job j's answers `rows`: the document,
    then each row's question and its tokens but the last."""
    t, q = cell.traffic, cell.qcfg
    doc, qs = inputs(cell, j)
    out = out[rows]
    Tq = t["question_tokens"]
    cont = np.concatenate([qs[rows], out[:, :-1]], axis=1)
    g = cell.family.reference.group(
        torch.from_numpy(doc), 0, torch.from_numpy(cont), q.residual_length,
        q.value_flush, extend=Tq)
    return g, Tq, torch.from_numpy(out.astype(np.int64))


def release(st: State) -> None:
    st.eng = None
