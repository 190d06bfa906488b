"""The K-EXAONE block on the port (`ExaoneMoEConfig`): sliding layers on
bf16 rings, full layers on KIVI-2, QK-norm, post-norms and the sparse
expert layer, held against the benchmark's plain f32 reference
(`kvbench/reference/exaone_moe.py`) on seeded random weights.

Sizes: 8 layers (`LLLG` twice, layer 0 dense), 8 query over 2 KV heads
of 32, hidden 128, 16 experts of width 64 (4 chosen a token, experts 4-7
held), a window of 16 = residual_length, group 8; f32 weights, caches
and scales on the CPU, so that what differs between the program and the
reference is the order of f32 sums alone.
"""

import contextlib
import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import ring_cache as RC
from kivi_tpu_torch.config import ExaoneMoEConfig, QuantConfig
from kivi_tpu_torch.kernels import moe_grouped
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving import engine as TE
from kivi_tpu_torch.serving.engine import Engine
from kvbench.reference import exaone_moe as REF

torch.set_num_threads(2)

W = 16
CFG = ExaoneMoEConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=8,
    num_heads=8, num_kv_heads=2, head_dim=32, rms_norm_eps=1e-5,
    rope_theta=1e6, sliding_window=W,
    layer_types=("sliding",) * 3 + ("full",) + ("sliding",) * 3 + ("full",),
    num_experts=16, experts_here=(4, 5, 6, 7), experts_per_tok=4,
    moe_intermediate_size=64, max_position_embeddings=1024)
QCFG = QuantConfig(2, 2, 8, W, v_flush=W, scale_dtype="float32")
B, DOC, TQ, NEW, TMAX = 3, 70, 9, 24, 256

# The program and the reference compute the same f32 function: they
# differ by the order of f32 sums (4e-6 here, |logits| ~ 3) and by
# nothing else, so 2e-4 holds them with room for another platform's
# order.  Rounding the expert layer's or the attention's input to fp16
# moves the logits by 0.3 and 0.9 (a rounding flips a later layer's
# choice of experts), dropping the correction bias by 1.7 and rotating
# the full layers by 1.5: each fails it by far (test_tolerance_catches).
LOGIT_ATOL = 2e-4


def _params(cfg=CFG, seed=0):
    return modeling.init_params(cfg, seed, torch.float32, "cpu")


def _engine(params, cfg=CFG, batch=B):
    return Engine(cfg, QCFG, params, max_seq_len=TMAX, batch_size=batch,
                  device="cpu", cache_dtype=torch.float32)


def _program_logits(eng, doc, qs, new):
    """(tokens (B, new), logits (B, new, V)): the prefix prefilled, the
    questions extended over its fan-out, new - 1 replayed decode steps;
    the logits of the first token and of every step."""
    got = []
    ingest, body = eng._ingest_prompt, eng._decode_body

    def spy_ingest(*a, **kw):
        pr = ingest(*a, **kw)
        got.append(pr.logits.clone())
        return pr

    def spy_body(st, *a):
        body(st, *a)
        got.append(st.logits.clone())

    eng._ingest_prompt, eng._decode_body = spy_ingest, spy_body
    snap = eng.prefill_prefix(doc)
    out = eng.generate(qs, new, prefix=snap)
    eng._ingest_prompt, eng._decode_body = ingest, body
    return out, torch.stack(got, 1)


def _reference_logits(params, doc, qs, out, cfg=CFG):
    cont = torch.cat([qs, out[:, :-1].long()], 1)
    g = REF.group(doc, 0, cont, QCFG.residual_length, QCFG.value_flush,
                  extend=qs.shape[1])
    lg = REF.logits(params, cfg, QCFG, [g])[0]
    return lg[:, qs.shape[1]:qs.shape[1] + out.shape[1]]


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    doc = torch.from_numpy(rng.integers(0, CFG.vocab_size, DOC))
    qs = torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, TQ)))
    return doc, qs


def _gap(params, prog_params=None, patch=None):
    """max |program - reference| over the logits of a prefixed generate;
    the program may take other params or run under a patch."""
    doc, qs = _inputs()
    eng = _engine(params if prog_params is None else prog_params)
    with patch() if patch else contextlib.nullcontext():
        out, got = _program_logits(eng, doc, qs, NEW)
    want = _reference_logits(params, doc, qs, out)
    return float((got - want).abs().max())


def test_program_matches_reference():
    """Prefill of a 70-token prefix (positions past the window and whole
    quantization groups), the questions' extend, 23 decode steps across
    K and V flushes and ring wrap-arounds: every logit within
    LOGIT_ATOL of the reference's full forward."""
    assert _gap(_params()) < LOGIT_ATOL


@contextlib.contextmanager
def _fp16_experts():
    orig = moe_grouped.experts

    def rounded(x, *a, **kw):
        return orig(x.half().float(), *a, **kw)

    moe_grouped.experts = rounded
    try:
        yield
    finally:
        moe_grouped.experts = orig


@contextlib.contextmanager
def _rope_everywhere():
    orig = ExaoneMoEConfig.rotates
    ExaoneMoEConfig.rotates = lambda self, layer: True
    try:
        yield
    finally:
        ExaoneMoEConfig.rotates = orig


@contextlib.contextmanager
def _fp16_attention():
    orig = modeling._hybrid_attention

    def rounded(x, *a, **kw):
        return orig(x.half().float(), *a, **kw)

    modeling._hybrid_attention = rounded
    try:
        yield
    finally:
        modeling._hybrid_attention = orig


def _no_bias(params):
    p = copy.deepcopy(params)
    for lp in p["layers"]:
        if "router_bias" in lp:
            lp["router_bias"].zero_()
    return p


@pytest.mark.parametrize("fault", ["fp16 experts", "fp16 attention",
                                   "no correction bias", "rope on full"])
def test_tolerance_catches(fault):
    """Each departure the tolerance is set to catch moves some logit by
    more than LOGIT_ATOL."""
    params = _params()
    if fault == "no correction bias":
        gap = _gap(params, prog_params=_no_bias(params))
    else:
        gap = _gap(params, patch={"fp16 experts": _fp16_experts,
                                  "fp16 attention": _fp16_attention,
                                  "rope on full": _rope_everywhere}[fault])
    assert gap > 10 * LOGIT_ATOL, gap


def test_correction_bias_is_drawn():
    lps = _params()["layers"][CFG.first_k_dense:]
    assert all(float(lp["router_bias"].abs().min()) > 0 for lp in lps)


def test_shares_add_up_to_the_uncut_layer():
    """The expert layer of four shards (experts 0-3, 4-7, 8-11, 12-15),
    each with the shared expert, less the shared expert counted three
    times too often, equals the reference's layer holding all 16."""
    uncut = dataclasses.replace(CFG, experts_here=tuple(range(16)))
    lp = _params(uncut)["layers"][1]
    x = torch.randn(2, 11, CFG.hidden_size, generator=torch.Generator()
                    .manual_seed(3))
    total = 0
    for s in range(4):
        cfg = dataclasses.replace(CFG, experts_here=tuple(range(4 * s,
                                                              4 * s + 4)))
        part = dict(lp, **{k: lp[k][4 * s:4 * s + 4]
                           for k in ("we_g", "we_u", "we_d")})
        total = total + modeling.moe_mlp(x, part, cfg)
    shared = modeling.swiglu_mlp(x, lp["ws_g"], lp["ws_u"], lp["ws_d"])
    got = total - 3 * shared
    want = REF.moe(REF._Mat(False), x.reshape(-1, CFG.hidden_size), lp,
                   uncut).reshape(x.shape)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # and a share is its part alone: experts 4-7 differ from the uncut
    assert (modeling.moe_mlp(x, dict(lp, **{k: lp[k][4:8] for k in (
        "we_g", "we_u", "we_d")}), CFG) - want).abs().max() > 1e-2


def test_grouped_plain_matches_per_token_loop():
    """The plain grouped GEMM over the sorted pairs equals a per-token
    loop over each token's held choices."""
    g = torch.Generator().manual_seed(5)
    N, Hd, I, E, k, first = 37, 32, 16, 4, 3, 2
    x = torch.randn(N, Hd, generator=g)
    idx = torch.stack([torch.randperm(9, generator=g)[:k] for _ in range(N)])
    w = torch.rand(N, k, generator=g)
    wg, wu = torch.randn(2, E, Hd, I, generator=g) * Hd ** -0.5
    wd = torch.randn(E, I, Hd, generator=g) * I ** -0.5
    log = moe_grouped.ExpertLog(E, "cpu", cap=4)
    got = moe_grouped.experts(x, idx, w, wg, wu, wd, first, log)
    want = torch.zeros_like(x)
    for t in range(N):
        for j in range(k):
            e = int(idx[t, j]) - first
            if 0 <= e < E:
                h = torch.nn.functional.silu(x[t] @ wg[e]) * (x[t] @ wu[e])
                want[t] += w[t, j] * (h @ wd[e])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    counts = [int(((idx - first) == e).sum()) for e in range(E)]
    assert log.calls() == [counts]
    t = log.totals(torch.zeros(1, dtype=torch.int64))
    assert t.tolist() == [sum(counts), max(counts), counts.count(0)]


def test_expert_library_is_built_at_first_use(monkeypatch):
    """`build_all` compiles and loads every library but row 13's, which
    `library("moe_grouped")` builds and loads alone at its first call,
    in its own `kernels.build` span; a second call builds nothing."""
    from kivi_tpu_torch.kernels import _build
    from kivi_tpu_torch.utils import profiling
    built, loaded = [], []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_compile",
                        lambda name: built.append(name))   # None: on disk
    monkeypatch.setattr(_build, "_load",
                        lambda path, name: loaded.append(name) or name)
    _build.build_all()
    assert built == loaded == list(_build.EAGER)
    assert "moe_grouped" in _build.LAZY and "moe_grouped" not in loaded
    profiling.drain()
    profiling.enable()
    try:
        assert _build.library("moe_grouped") == "moe_grouped"
        _build.library("moe_grouped")
        _build.build_all()
    finally:
        profiling.disable()
    assert built[len(_build.EAGER):] == loaded[len(_build.EAGER):] == [
        "moe_grouped"]
    spans = [sp for sp in profiling.drain() if sp.name == "kernels.build"]
    assert [(sp.attrs["lib"], sp.attrs["n"]) for sp in spans] == [
        ("moe_grouped", 0)]


# ---------------------------------------------------------------------------
# the ring against windowed attention over a whole fp cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,chunk", [(5, 3), (10, 12), (40, 7),
                                          (16, 40)])
def test_ring_equals_windowed_fp_cache(prompt, chunk):
    """A prompt, an extend of `chunk` tokens, then 30 decode steps (the
    ring wraps around): rows shorter than the window (5 + 3), an extend
    crossing its edge (10 + 12) or longer than it (16 + 40); host-int
    steps, then per-row device counters."""
    g = torch.Generator().manual_seed(prompt * 100 + chunk)
    Bb, H, r, D = 2, 2, 4, 8
    T = prompt + chunk + 30
    k = torch.randn(Bb, H, T, D, generator=g)
    v = torch.randn(Bb, H, T, D, generator=g)
    q = torch.randn(Bb, H * r, T, D, generator=g)
    ring = RC.init_ring_cache(Bb, H, D, W, torch.float32, "cpu")
    fp = FC.init_fp_cache(Bb, H, D, 128, torch.float32, "cpu")
    RC.ring_prefill(ring, k[:, :, :prompt], v[:, :, :prompt])
    FC.fp_append(fp, k[:, :, :prompt], v[:, :, :prompt])
    s, e = prompt, prompt + chunk
    got = RC.ring_extend_attention(q[:, :, s:e], k[:, :, s:e],
                                   v[:, :, s:e], ring)
    want = FC.fp_extend_attention(q[:, :, s:e], k[:, :, s:e], v[:, :, s:e],
                                  fp, sliding_window=W)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    RC.ring_append(ring, k[:, :, s:e], v[:, :, s:e])
    FC.fp_append(fp, k[:, :, s:e], v[:, :, s:e])
    for t in range(e, T):
        if t == e + 15:           # the engine's replayed decode from here
            ring.length = torch.full((Bb,), ring.length, dtype=torch.int32)
        RC.ring_decode_append(ring, k[:, :, t:t + 1], v[:, :, t:t + 1])
        FC.fp_append(fp, k[:, :, t:t + 1], v[:, :, t:t + 1])
        got = RC.ring_decode_attention(q[:, :, t:t + 1], ring)
        want = FC.fp_decode_attention(q[:, :, t:t + 1], fp,
                                      sliding_window=W)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert int(ring.length[0]) == T


def test_fan_out_copies_the_ring():
    """The engine's fan-out writes every row of the own caches from the
    snapshot's one: rings included, their slots and their counter."""
    eng = _engine(_params())
    doc, _ = _inputs()
    snap = eng.prefill_prefix(doc)
    caches = eng._fan_out(snap)
    for c, s in zip(caches, snap.caches):
        if isinstance(c, RC.RingLayerCache):
            assert c.length == DOC
            assert torch.equal(c.k, s.k.expand_as(c.k))
            assert torch.equal(c.v, s.v.expand_as(c.v))
    assert sum(isinstance(c, RC.RingLayerCache) for c in caches) == 6


# ---------------------------------------------------------------------------
# the replayed decode step
# ---------------------------------------------------------------------------

_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__", "nonzero")


@contextlib.contextmanager
def _no_host_reads():
    saved = {n: getattr(torch.Tensor, n) for n in _READS}

    def refuse(name):
        def raiser(*a, **kw):
            raise AssertionError(f"a host read ({name}) in the step")
        return raiser

    for n in _READS:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def _guarded(fn):
    def wrapped(*a, **kw):
        with _no_host_reads():
            return fn(*a, **kw)
    return wrapped


def test_decode_step_keeps_storage_and_reads_nothing(monkeypatch):
    """Three replayed-step bodies over the engine's caches with a
    scheduled flush between them: every tensor of the state, the rings,
    the KIVI caches and the expert log keeps its storage; the ring's
    append and attention and the expert layer read nothing back."""
    monkeypatch.setattr(RC, "ring_decode_append",
                        _guarded(RC.ring_decode_append))
    monkeypatch.setattr(RC, "ring_decode_attention",
                        _guarded(RC.ring_decode_attention))
    monkeypatch.setattr(modeling, "moe_mlp", _guarded(modeling.moe_mlp))
    eng = _engine(_params())
    prompt = 45               # 13 keys and 13 values in the windows
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG.vocab_size, (B, prompt)))
    first, caches = eng.prefill(toks)
    st = eng._decode_begin(first, torch.full((B, 1), prompt), caches, None,
                           None)
    events = TE.flush_schedule(QCFG, TE.canonical_phase(QCFG, prompt), 5)
    assert 3 in events

    def named():
        out = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
               if isinstance(getattr(st, f.name), torch.Tensor)}
        for i, c in enumerate(caches):
            for f in dataclasses.fields(c):
                out[f"{i}.{f.name}"] = getattr(c, f.name)
        out["log.rows"], out["log.n"] = eng.experts.rows, eng.experts.n
        return {k: t.data_ptr() for k, t in out.items()}

    before = named()
    assert any(k.endswith(".length") for k in before)
    n0 = int(eng.experts.n)
    fb = TE.fill_bound(prompt, 5)
    for i in range(5):
        if i in events:
            modeling.flush_caches(caches, QCFG, k=events[i][0],
                                  v=events[i][1])
        eng._decode_body(st, fb, False, 0.0, 0, 1.0, 1.0, None)
        assert named() == before, i
    assert int(eng.experts.n) - n0 == 5 * (CFG.num_layers - 1)
    eng._decode_end(st, 5)
    assert all(c.seq_len == prompt + 5 for c in caches)


def test_spans_carry_the_expert_counts():
    """With the tracer on, the engine's spans carry the expert log's
    totals (read when the tracer drains) and the ring layers."""
    from kivi_tpu_torch.utils import profiling
    eng = _engine(_params())
    doc, qs = _inputs()
    profiling.drain()
    profiling.enable()
    try:
        snap = eng.prefill_prefix(doc)
        eng.generate(qs, 6, prefix=snap)
    finally:
        profiling.disable()
    spans = {s.name: s for s in profiling.drain()}
    calls = eng.experts.calls()
    moe = CFG.num_layers - CFG.first_k_dense
    assert len(calls) == moe * (1 + 1 + 5)
    for name, rows in (("engine.prefill_prefix", calls[:moe]),
                       ("engine.ingest", calls[moe:2 * moe]),
                       ("engine.decode", calls[2 * moe:])):
        a = spans[name].attrs
        assert a["ring_layers"] == 6
        assert a["routed"] == sum(map(sum, rows))
        assert a["expert_max"] == max(map(max, rows))
        assert a["experts_idle"] == sum(r.count(0) for r in rows)


# ---------------------------------------------------------------------------
# the paths not ported to the rings say so
# ---------------------------------------------------------------------------

def _raises(fn):
    with pytest.raises(NotImplementedError, match="sliding-ring"):
        fn()


def test_batcher_raises():
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher
    _raises(lambda: ContinuousBatcher(CFG, QCFG, _params(), num_slots=2,
                                      max_seq_len=TMAX, device="cpu"))


def test_speculative_engine_raises():
    from kivi_tpu_torch.serving.speculative import SpeculativeEngine
    eng = _engine(_params(), batch=1)
    _raises(lambda: SpeculativeEngine(eng, eng))


def test_speculative_batcher_raises():
    from kivi_tpu_torch.serving.spec_batcher import SpeculativeBatcher
    p = _params()
    _raises(lambda: SpeculativeBatcher(CFG, QCFG, p, CFG, QCFG, p,
                                       num_slots=2, max_seq_len=TMAX,
                                       device="cpu"))


def test_beam_raises():
    eng = _engine(_params(), batch=2)
    _raises(lambda: eng.generate_beam(torch.zeros(1, 4, dtype=torch.long),
                                      3, num_beams=2))


@pytest.mark.parametrize("arg", ["tp", "seq_group", "pad_len"])
def test_parallel_and_pads_raise(arg):
    p = _params()
    caches = modeling.init_caches(CFG, QCFG, 1, TMAX, torch.float32, "cpu")
    tok = torch.zeros(1, 4, dtype=torch.long)
    kw = {"pad_len": torch.zeros(1, dtype=torch.long)} if arg == "pad_len" \
        else {arg: object()}
    _raises(lambda: modeling.forward(p, tok, caches, CFG, QCFG,
                                     torch.arange(4)[None], mode="prefill",
                                     **kw))


def test_engine_mesh_raises():
    _raises(lambda: Engine(CFG, QCFG, _params(), max_seq_len=TMAX,
                           batch_size=1, device="cpu", mesh=object()))


# ---------------------------------------------------------------------------
# the benchmark's family and driver, one tiny cell on the CPU
# ---------------------------------------------------------------------------

def _tiny_root(tmp: str) -> str:
    """A root with the benchmark's files and a tiny K-EXAONE cell: the
    real configuration's file with the tiny sizes, and docqa-32k's
    traffic cut to the CPU."""
    from kvbench.tests.tiny import make_root
    root = make_root(tmp)
    kv = os.path.join(root, "kvbench")
    with open(os.path.join(kv, "configs", "k-exaone-236b-a23b-ep8.json")) as f:
        conf = json.load(f)
    model = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    model.update(layer_types=list(CFG.layer_types),
                 experts_here=list(CFG.experts_here))
    conf["model"] = model
    conf["quant"] = dict(dataclasses.asdict(QCFG), scale_dtype="bfloat16")
    with open(os.path.join(kv, "configs", "tiny-exaone.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(kv, "traffic", "docqa-32k.json")) as f:
        traffic = json.load(f)
    traffic.update(doc_tokens=70, questions=3, question_tokens=9,
                   new_tokens=20, max_seq_len=TMAX)
    traffic["check"] = dict(traffic["check"], rows=2)
    with open(os.path.join(kv, "traffic", "tiny-docqa-hybrid.json"),
              "w") as f:
        json.dump(traffic, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-exaone", "source": "tiny",
                             "file": "kvbench/configs/tiny-exaone.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-exaone.docqa",
                               "config": "tiny-exaone",
                               "traffic": "tiny-docqa-hybrid", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "k-exaone.docqa-32k" in m.get("workloads", []):
            m["workloads"].append("tiny-exaone.docqa")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_family_and_driver_run_a_tiny_cell(tmp_path, monkeypatch):
    """One run of a tiny K-EXAONE cell through the family and the hybrid
    driver: correct, the windows compared from the KIVI layers alone."""
    from kvbench import run
    root = _tiny_root(str(tmp_path))
    seen = []
    orig = REF.window_gap

    def spy(g, ref_kv, prog):
        seen.append((len(ref_kv[0]), len(prog.get("counts", ()))))
        return orig(g, ref_kv, prog)

    monkeypatch.setattr(REF, "window_gap", spy)
    res, rec = run.run_cell(root, "tiny-exaone.docqa", 2 ** 31 + 7, 1.0,
                            True, "cpu")
    assert res["correct"], res["check"]
    assert rec.family.__name__ == "kvbench_family_exaone_moe"
    assert res["check"]["window_layers"]["value"] == 0
    assert seen == [(2, 2)]
    assert set(res["metrics"]) == {"prompt_share.gen", "decode_step_ms.gen"}
