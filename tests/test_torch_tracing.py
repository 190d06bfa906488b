"""The port's tracer (kivi_tpu_torch.utils.profiling, CPU): the spans the
batcher and the engine record, their nesting and attributes, nothing
recorded with the tracer off, the same tokens with it on and off, and
program spans on the clock the benchmark maps onto a profiler trace."""

import threading

import numpy as np
import pytest
import torch

from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import (Engine, canonical_phase,
                                           fill_bound, flush_schedule)
from kivi_tpu_torch.serving.prefix_cache import PrefixCache
from kivi_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

CFG = tiny_config()
Q = QuantConfig(k_bits=2, v_bits=2, group_size=32, residual_length=32,
                scale_dtype="float32")
MAX = 256
BUCKETS = (32, 64)
ADMIT_PARTS = ["batcher.admit.prefill", "batcher.admit.sample",
               "batcher.admit.write_slot", "batcher.admit.read"]


@pytest.fixture
def tracer():
    P.drain()
    P.enable()
    try:
        yield P
    finally:
        P.disable()
        P.drain()


def _params():
    return modeling.init_params(CFG, 0, dtype=torch.float32, device="cpu")


def _engine(params, batch=1):
    return Engine(CFG, Q, params, max_seq_len=MAX, batch_size=batch,
                  device="cpu", cache_dtype=torch.float32)


def _batcher(params):
    return ContinuousBatcher(CFG, Q, params, num_slots=2, max_seq_len=MAX,
                             device="cpu", prompt_buckets=BUCKETS,
                             prefix_cache=PrefixCache(_engine(params)),
                             cache_dtype=torch.float32)


def _requests(temperature=None):
    """Bucketed and prefix requests, more than the slots; greedy and
    sampled in turn unless `temperature` fixes every one."""
    rng = np.random.default_rng(3)
    prefix = [int(t) for t in rng.integers(0, CFG.vocab_size, 40)]
    out = []
    for uid, (n, pfx, new) in enumerate([(5, False, 6), (20, False, 4),
                                         (40, False, 7), (6, True, 5),
                                         (33, False, 1), (9, True, 6)]):
        t = (0.8 if uid % 2 else 0.0) if temperature is None else temperature
        out.append(Request(
            uid=uid, prompt=[int(x) for x in
                             rng.integers(0, CFG.vocab_size, n)],
            max_new_tokens=new, temperature=t, top_p=0.9,
            prefix_tokens=prefix if pfx else None))
    return out


def _tokens(results):
    return {u: r.tokens for u, r in results.items()}


def test_batcher_spans(tracer):
    params = _params()
    bat = _batcher(params)
    reqs = _requests()
    res = bat.run(reqs)
    spans = tracer.drain()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    admits = by["batcher.admit"]
    assert sorted(s.attrs["uid"] for s in admits) == [r.uid for r in reqs]
    kids = {}
    for s in spans:
        kids.setdefault(id(s.parent), []).append(s)
    for a in admits:
        assert a.parent.name == "batcher.step"
        parts = sorted(kids[id(a)], key=lambda s: s.start_ns)
        assert [s.name for s in parts] == ADMIT_PARTS
        assert a.start_ns <= parts[0].start_ns and parts[-1].end_ns <= \
            a.end_ns
    # an admission closes before the next one opens
    starts = sorted((a.start_ns, a.end_ns) for a in admits)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(starts, starts[1:]))
    want = {r.uid: (len(r.prompt) if r.prefix_tokens is not None
                    else bat._bucket_for(len(r.prompt))) for r in reqs}
    for a in admits:
        r = reqs[a.attrs["uid"]]
        assert a.attrs["prompt"] == len(r.prompt)
        assert a.attrs["bucket"] == want[r.uid]
        assert a.attrs["prefix"] == (r.prefix_tokens is not None)
    pads = sum(a.attrs["bucket"] - a.attrs["prompt"] for a in admits)
    assert pads == sum(want[r.uid] - len(r.prompt) for r in reqs) > 0
    # every decoded slot emits one token after the first
    steps = by["batcher.step"]
    assert sum(s.attrs["active"] for s in steps) == sum(
        len(t) - 1 for t in _tokens(res).values())
    assert sum(s.attrs["admitted"] for s in steps) == len(reqs)
    for s in steps:
        names = sorted(k.name for k in kids.get(id(s), []))
        want_names = ["batcher.retire"] + ["batcher.admit"] * \
            s.attrs["admitted"]
        if s.attrs["active"]:
            want_names += ["batcher.decode", "batcher.emit", "batcher.read"]
            dec = next(k for k in kids[id(s)] if k.name == "batcher.decode")
            assert dec.attrs["fb"] == s.attrs["fb"]
        assert names == sorted(want_names + ["batcher.queue"]
                               * s.attrs["admitted"])
    queue = {s.attrs["uid"]: s for s in by["batcher.queue"]}
    assert sorted(queue) == [r.uid for r in reqs]
    for a in admits:
        q = queue[a.attrs["uid"]]
        assert q.start_ns <= q.end_ns <= a.start_ns
    assert sum(s.attrs["retired"] for s in by["batcher.retire"]) == len(reqs)
    assert not bat._submitted


def test_engine_spans(tracer):
    eng = _engine(_params(), batch=2)
    rng = np.random.default_rng(4)
    snap = eng.prefill_prefix(torch.from_numpy(
        rng.integers(0, CFG.vocab_size, 40)))
    qs = torch.from_numpy(rng.integers(0, CFG.vocab_size, (2, 6)))
    eng.generate(qs, 40, prefix=snap)
    spans = tracer.drain()
    by = {s.name: s for s in spans}
    assert sorted(by) == ["engine.decode", "engine.decode.read",
                          "engine.generate", "engine.ingest",
                          "engine.prefill_prefix"]
    assert len(spans) == 5
    assert by["engine.prefill_prefix"].attrs == {"tokens": 40}
    assert by["engine.prefill_prefix"].parent is None
    gen = by["engine.generate"]
    assert gen.attrs == {"B": 2, "T": 6, "new": 40} and gen.parent is None
    ing, dec = by["engine.ingest"], by["engine.decode"]
    assert ing.parent is gen and dec.parent is gen
    assert ing.attrs == {"prefix": 40} and ing.end_ns <= dec.start_ns
    flushes = len(flush_schedule(Q, canonical_phase(Q, 46), 39))
    # a 40-token prefix holds no whole chunk of shared positions
    assert dec.attrs == {"steps": 39, "fb": fill_bound(46, 39),
                         "flushes": flushes, "shared": 0} and flushes > 0
    assert by["engine.decode.read"].parent is dec
    # no device on the CPU: no device time
    assert all(s.device_ms is None for s in spans)


def test_tracer_off_records_nothing():
    P.disable()
    P.drain()
    params = _params()
    _batcher(params).run(_requests())
    eng = _engine(params)
    snap = eng.prefill_prefix(torch.arange(40))
    eng.generate(torch.arange(6)[None], 5, prefix=snap)
    assert P.drain() == []
    a, b = P.span("a", device=True, x=1), P.span("b")
    assert a is b
    with a as s:
        s.attrs["n"] = 3
    assert s.attrs == {} and P.drain() == []


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tokens_equal_on_and_off(temperature):
    params = _params()
    gen_q = torch.from_numpy(np.random.default_rng(5).integers(
        0, CFG.vocab_size, (2, 6)))
    got = []
    for on in (False, True, False):
        P.drain()
        (P.enable if on else P.disable)()
        try:
            res = _tokens(_batcher(params).run(_requests(temperature)))
            eng = _engine(params, batch=2)
            snap = eng.prefill_prefix(torch.arange(40))
            g = torch.Generator().manual_seed(7)
            out = eng.generate(gen_q, 12, prefix=snap,
                               temperature=temperature, top_p=0.9,
                               generator=g)
        finally:
            P.disable()
        assert bool(P.drain()) == on
        got.append((res, out))
    for res, out in got[1:]:
        assert res == got[0][0]
        assert torch.equal(out, got[0][1])


def test_record_attrs_and_nesting_per_thread(tracer):
    with tracer.span("outer", k=1) as outer:
        outer.attrs["set"] = 2
        tracer.record("earlier", 5, 9, uid=3)
        seen = {}

        def other():
            with tracer.span("in_thread") as s:
                seen["parent"] = s.parent

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracer.span("inner") as inner:
            pass
    assert seen["parent"] is None
    assert inner.parent is outer and outer.parent is None
    spans = {s.name: s for s in tracer.drain()}
    assert spans["outer"].attrs == {"k": 1, "set": 2}
    e = spans["earlier"]
    assert (e.start_ns, e.end_ns, e.attrs, e.parent) == (5, 9, {"uid": 3},
                                                         outer)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert tracer.drain() == []


def test_program_span_meets_the_trace_clock(tracer):
    """A program span goes onto the profiler's clock by the offset the
    benchmark uses for its own spans (kvbench/trace.py): a CPU
    operator's event, stamped by the profiler, lands inside the program
    span around it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from kvbench import trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = trace._clock_offset_us()
        with tracer.span("probe") as s:
            with record_function("kvb.program_probe"):
                torch.ones(64).sum()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "kvb.program_probe"][0]
    a, b = s.start_ns / 1e3 + off, s.end_ns / 1e3 + off
    lo, hi = ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3
    assert a - 50 <= lo <= hi <= b + 50
