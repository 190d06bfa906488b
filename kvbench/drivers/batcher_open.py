"""Open-loop serving through the continuous batcher: requests arrive on a
schedule fixed before the run, whatever the batcher does, and a host loop
submits each one when it is due and calls `ContinuousBatcher.step()`
while any is in flight.

Traffic parameters: batcher (num_slots, max_seq_len, prompt_buckets);
rate (requests a second); preroll_s (arrivals before the window, so that
the slots are as full as they stay); drain_s (how long past the window
the requests due in it are waited for); prompt and output lengths
({min, max}: prompts log-uniform, outputs uniform); greedy_share and the
sampled requests' controls; shape_seed; profile_steps (steps profiled in
a traced run); check.requests (greedy answers compared) and
check.limits.

Every seed gets the same arrival times, and the same lengths and greedy
flags before, in and after the window, all drawn from shape_seed; the
seed orders the lengths within each of the three and draws the prompts'
tokens.  No request carries an EOS: it ends at its length.

Each request is timed from when it was due.  Counts: per request its due
time, lengths, every token's host time (`Request.on_token`) and the step
that admitted it; per step its start and end, the requests it admitted
and those it decoded; a `step` span each.  A traced run profiles
profile_steps steps from the window's close on, while its requests
drain and arrivals go on: the profiler's host cost (some hundreds of
ms a step where admissions run eagerly) stays out of the window's
spans and counts.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kvbench import roofline, trace


def bucket(n: int, buckets) -> int:
    return next(b for b in buckets if n <= b)


def schedule(cell) -> dict:
    """The run's requests, in arrival order: due (s from the window's
    start), prompt and output lengths, greedy flags, and the prompts.
    Arrivals are Poisson given their count: rate x the length of the
    pre-roll, of the window and of the drain, each at uniform times in
    its span.  The times and the lengths come from shape_seed alone; the
    seed draws the prompts' tokens and the order of the lengths among the
    arrivals of each span, so that every seed offers the window the same
    work."""
    t = cell.traffic
    rate, pre, drain = t["rate"], t["preroll_s"], t["drain_s"]
    shape = np.random.default_rng(t["shape_seed"])
    due = np.concatenate([np.sort(shape.uniform(a, b, round(rate * (b - a))))
                          for a, b in ((-pre, 0.0), (0.0, cell.seconds),
                                       (cell.seconds, cell.seconds + drain))])
    n = len(due)
    pl, ol = t["prompt"], t["output"]
    plen = np.exp(shape.uniform(math.log(pl["min"]), math.log(pl["max"] + 1),
                                n)).astype(np.int64).clip(pl["min"],
                                                          pl["max"])
    olen = shape.integers(ol["min"], ol["max"] + 1, n)
    greedy = shape.permutation(np.arange(n) < round(n * t["greedy_share"]))
    run = np.random.default_rng([int(cell.seed), 2])
    seg = np.searchsorted([0.0, float(cell.seconds)], due, side="right")
    for k in range(3):
        idx = np.flatnonzero(seg == k)
        perm = idx[run.permutation(len(idx))]
        plen[idx], olen[idx], greedy[idx] = plen[perm], olen[perm], \
            greedy[perm]
    toks = run.integers(0, cell.cfg.vocab_size, int(plen.sum()))
    cuts = np.cumsum(plen)[:-1]
    return {"due": due, "plen": plen, "olen": olen, "greedy": greedy,
            "prompts": np.split(toks, cuts)}


class State:
    def __init__(self, cell, params):
        b = cell.traffic["batcher"]
        self.buckets = tuple(b["prompt_buckets"])
        self.bat = ContinuousBatcher(
            cell.cfg, cell.qcfg, params, num_slots=b["num_slots"],
            max_seq_len=b["max_seq_len"], device=cell.device,
            prompt_buckets=self.buckets)
        self.uid = 0
        self.served: dict = {}      # the last window's requests, served
        self.prompts: list = []     # and its prompts, for the check


def _request(st: State, cell, prompt, max_new, greedy, on_token) -> Request:
    s = cell.traffic["sampled"]
    st.uid += 1
    return Request(uid=st.uid, prompt=[int(x) for x in prompt],
                   max_new_tokens=int(max_new),
                   temperature=0.0 if greedy else s["temperature"],
                   top_p=1.0 if greedy else s["top_p"], on_token=on_token)


def warm_plan(cell, buckets) -> list:
    """[(bucket, decode steps)]: one lone request per prompt bucket the
    traffic reaches, run for as many steps as its fills need to reach
    every fill bound (one captured graph each) that bucket can give."""
    t = cell.traffic
    T = t["batcher"]["max_seq_len"]
    lo, hi = t["prompt"]["min"], t["prompt"]["max"]
    used = sorted({bucket(n, buckets + (T,))
                   for n in (lo, hi, *[b for b in buckets if lo <= b <= hi])})
    plan, seen = [], set()
    for b in used:
        steps = 1
        for k in range(t["output"]["max"]):
            fb = min(-(-(b + k + 1) // 512) * 512, T)
            if fb not in seen:
                seen.add(fb)
                steps = k + 1
        plan.append((b, steps))
    return plan


def setup(cell, params) -> State:
    """The batcher, every prompt bucket's prefill and every fill bound's
    decode graph warmed by lone requests (greedy and sampled in turn)."""
    st = State(cell, params)
    rng = np.random.default_rng([int(cell.seed), 1])
    for i, (b, steps) in enumerate(warm_plan(cell, st.buckets)):
        prompt = rng.integers(0, cell.cfg.vocab_size, b)
        st.bat.run([_request(st, cell, prompt, steps + 1, i % 2 == 0,
                             None)])
    trace.sync(cell.device)
    return st


def window(st: State, cell, rec) -> None:
    t = cell.traffic
    sch = schedule(cell)
    n = len(sch["due"])
    reqs = [{"due": 0.0, "plen": int(sch["plen"][i]),
             "max_new": int(sch["olen"][i]), "greedy": bool(sch["greedy"][i]),
             "times": [], "tokens": [], "admit_step": None,
             "admit_s": None} for i in range(n)]
    step = {"start": 0.0, "last": 0.0, "admitted": [], "rows": []}

    def on_token(i):
        r = reqs[i]

        def cb(tok):
            now = time.perf_counter()
            if not r["times"]:
                r["admit_step"] = step["start"]
                r["admit_s"] = now - step["last"]
                step["last"] = now
                step["admitted"].append(i)
            else:
                step["rows"].append((r["plen"], len(r["times"]) - 1))
            r["times"].append(now)
            r["tokens"].append(tok)
            rec.token_times.append(now)
        return cb

    t0 = time.perf_counter() + t["preroll_s"]
    t1 = t0 + cell.seconds
    rec.t0, rec.window_s = t0, float(cell.seconds)
    due = t0 + sch["due"]
    in_window = (due >= t0) & (due < t1)
    left = int(in_window.sum())
    inflight: set = set()
    to_profile = int(t.get("profile_steps", 0)) if cell.trace else 0
    stack = contextlib.ExitStack()
    prof, counters = None, {"decode_rows": []}
    i = 0
    while True:
        now = time.perf_counter()
        while i < n and due[i] <= now:
            r = reqs[i]
            r["due"] = float(due[i])
            req = _request(st, cell, sch["prompts"][i], r["max_new"],
                           r["greedy"], on_token(i))
            st.bat.submit(req)
            inflight.add(i)
            i += 1
        if now >= t1 and left == 0 and not to_profile:
            break
        if now > t1 + t["drain_s"] or (not inflight and i >= n):
            break
        if not inflight:
            time.sleep(max(0.0, due[i] - now))
            continue
        if to_profile and prof is None and now >= t1:
            prof = stack.enter_context(
                trace.profiled(cell.spans, cell.device, counters))
        step.update(start=now, last=now, admitted=[], rows=[])
        with cell.spans.span("step"):
            st.bat.step()
        end = time.perf_counter()
        rec.steps.append({"start": now, "end": end,
                          "admitted": [reqs[a]["plen"]
                                       for a in step["admitted"]],
                          "rows": step["rows"]})
        if prof is not None and to_profile:
            counters["decode_rows"].append((_decode_rows(cell, step["rows"]),
                                            (0, 0)))
            to_profile -= 1
            if not to_profile:
                stack.close()
        for j in list(inflight):
            r = reqs[j]
            if len(r["times"]) >= r["max_new"]:
                inflight.discard(j)
                if t0 <= r["due"] < t1:
                    left -= 1
    stack.close()
    if prof:
        rec.profile = prof[0]
    rec.requests = [r for r, w in zip(reqs, in_window) if w]
    for r, w in zip(reqs, in_window):
        r["in_window"] = bool(w)
    st.served = {j: r for j, r in enumerate(reqs) if r["tokens"]}
    st.prompts = sch["prompts"]
    rec.attempted = len(rec.requests)
    rec.failed = sum(len(r["tokens"]) < r["max_new"] for r in rec.requests)
    forward = cell.family.roofline.forward
    for s in rec.steps:
        if not t0 <= s["start"] < t1:
            continue
        for p in s["admitted"]:
            rec.forwards.append(roofline.bound_s(*forward(
                cell.cfg, cell.qcfg, 1, p, logit_rows=1)))
        if s["rows"]:
            rows = _decode_rows(cell, s["rows"])
            rec.forwards.append(roofline.bound_s(*forward(
                cell.cfg, cell.qcfg, len(rows), 1, rows,
                logit_rows=len(rows), causal_new=False)))


def _decode_rows(cell, rows) -> list:
    """The cache counts each (prompt, step) row of a decode step reads."""
    q = cell.qcfg
    return [cell.family.reference.decode_counts(p, k, q.residual_length,
                                                q.value_flush)
            for p, k in rows]


def check_items(st: State, cell, rec) -> list:
    """[(Group, 0, tokens, None)]: the greedy requests due in the window
    that finished, the longest among them and check.requests - 1 more
    drawn from the seed; each request's logits at its last prompt token
    and at each served token but the last are compared with its tokens.
    (The sampled requests are not compared: PERF.md, section 2.)"""
    q = cell.qcfg
    done = [j for j, r in st.served.items()
            if r["greedy"] and r["in_window"]
            and len(r["tokens"]) == r["max_new"]]
    if not done:
        return []
    longest = max(done, key=lambda j: (st.served[j]["max_new"],
                                       st.served[j]["plen"]))
    rest = [j for j in done if j != longest]
    rng = np.random.default_rng([int(cell.seed), 0, 2])
    k = min(len(rest), cell.traffic["check"]["requests"] - 1)
    pick = [longest] + [rest[x] for x in rng.choice(len(rest), k,
                                                    replace=False)]
    items = []
    for j in pick:
        r = st.served[j]
        prompt = torch.from_numpy(st.prompts[j].astype(np.int64))
        toks = torch.tensor(r["tokens"], dtype=torch.long)
        pad = bucket(r["plen"], st.buckets
                     + (cell.traffic["batcher"]["max_seq_len"],)) - r["plen"]
        g = cell.family.reference.group(prompt, pad, toks[None, :-1],
                                        q.residual_length, q.value_flush)
        items.append((g, 0, toks[None], None))
    return items


def release(st: State) -> None:
    st.bat = None
