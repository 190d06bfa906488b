"""Tests of the port's replayed decode steps and of the decode kernels'
fill bound that need the card (a CUDA graph and a CUDA kernel have no
CPU mode): each skips without a CUDA device.  This file imports torch
and the port only, so that it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_graphs_cuda.py

  * the engine's decode replayed as CUDA graphs gives the tokens of the
    same body run eagerly from the same state (chunked, one-shot and
    fp16; greedy and sampled under one seed), and the tokens of
    `Engine(debug=True)` (that body run eagerly as a checked call);
  * the batcher's replayed step gives the eager body's tokens on every
    request (KIVI-2 and fp16, greedy and sampled rows);
  * rows 6 and 9 with t_bound equal the full grid bit for bit where the
    contract holds, and their plain versions under the bound, also
    where it is violated (max|kernel - plain| <= 1e-5 * max|plain| +
    1e-5, chip_smoke's tolerance);
  * `_build.LAUNCHES` counts the kernels of every replay;
  * a violated fill bound raises under a checked call;
  * the prefix paths (generate(prefix=), ragged suffixes, the stream,
    beam search with and without a prefix) and the batcher's prefix
    admission (its tail a batch-1 graph) give the eager body's tokens
    when replayed, and Engine(debug=True)'s;
  * with the tracer on, the replayed steps give the tokens of the
    tracer off, and a capture is one span.
"""

import functools

import pytest
import torch

from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.core.attention import decode_attention
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import fp_decode as FD
from kivi_tpu_torch.kernels import fused_decode as FR
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import Engine
from kivi_tpu_torch.utils import guards

CFG = tiny_config(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                  num_heads=4, num_kv_heads=2, head_dim=128)
KIVI = QuantConfig(2, 2, 32, 128, v_flush=128)
FP16 = QuantConfig(16, 16, 32, 128)
B, PROMPT, NEW, TMAX = 4, 300, 100, 1024
PADS = [0, 5, 17, 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def _params():
    return modeling.init_params(CFG, seed=0, device="cuda")


def _tokens(seed, shape):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, shape, generator=gen,
                         device="cuda")


def _engine(qcfg, *, debug=False, graphs=True):
    eng = Engine(CFG, qcfg, _params(), max_seq_len=TMAX, batch_size=B,
                 device="cuda", debug=debug)
    if not graphs:
        eng.graphs = None          # the same body, run eagerly
    return eng


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("path", ["chunked", "oneshot", "fp16"])
def test_engine_graph_matches_eager(cuda, path, sampled):
    """Decode across K and V flushes (300 prompt tokens leave 44 in each
    window, full after 84 steps), left pads on three rows."""
    qcfg = FP16 if path == "fp16" else KIVI
    toks = _tokens(1, (B, PROMPT))
    kw = dict(pad_lens=PADS,
              prefill_chunk_size=128 if path == "chunked" else None)
    if sampled:
        kw.update(temperature=0.8, top_k=50, top_p=0.9,
                  repetition_penalty=1.1)

    def run(eng):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        return eng.generate(toks, NEW, generator=gen, **kw)

    eng = _engine(qcfg)
    got = run(eng)
    assert len(eng.graphs) == 1
    again = run(eng)                   # every step a replay
    want = run(_engine(qcfg, graphs=False))
    assert torch.equal(got, want), (got != want).nonzero()[:4]
    assert torch.equal(again, want)
    dbg = run(_engine(qcfg, debug=True))
    assert torch.equal(dbg, want), (dbg != want).nonzero()[:4]


def test_engine_launches_count_replays(cuda):
    eng = _engine(KIVI)
    toks = _tokens(2, (B, PROMPT))
    eng.generate(toks, NEW, prefill_chunk_size=128)     # captures
    _build.LAUNCHES.clear()
    eng.generate(toks, NEW, prefill_chunk_size=128)     # replays only
    assert _build.LAUNCHES["fused_decode_attention"] == \
        (NEW - 1) * CFG.num_layers
    assert _build.LAUNCHES["fused_decode_attention_wide"] == 0


def _requests(seed, n):
    gen = torch.Generator()
    gen.manual_seed(seed)
    reqs = []
    for i in range(n):
        plen = int(torch.randint(40, 400, (), generator=gen))
        prompt = torch.randint(0, CFG.vocab_size, (plen,),
                               generator=gen).tolist()
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_p=0.9,
                                        repetition_penalty=1.2)
        reqs.append(Request(uid=i, prompt=prompt,
                            max_new_tokens=int(torch.randint(
                                20, 140, (), generator=gen)), **kw))
    return reqs


@pytest.mark.parametrize("bits,chunk", [(2, 0), (2, 128), (16, 0)])
def test_batcher_graph_matches_eager(cuda, bits, chunk):
    """8 requests through 3 slots, half sampled: every request's tokens
    equal between the replayed step and the eager body; one graph per
    fill bound met."""
    qcfg = KIVI if bits == 2 else FP16
    results = []
    for graphs in (True, False):
        bat = ContinuousBatcher(CFG, qcfg, _params(), num_slots=3,
                                max_seq_len=TMAX, device="cuda",
                                prompt_buckets=(128, 256, 512),
                                prefill_chunk=chunk)
        if not graphs:
            bat.graphs = None
        out = bat.run(_requests(bits + chunk, 8))
        results.append({u: r.tokens for u, r in out.items()})
        if graphs:
            bounds = [k for k in (512, 1024) if k in bat.graphs]
            assert len(bat.graphs) == len(bounds) > 0
    assert results[0] == results[1]


def _slot_cache(gen, qcfg, fills, heads=8, d=128, tmax=2048):
    """A cache with per-row device counters whose row s holds fills[s]
    tokens (0: an empty row), the last appended by the decode append."""
    rows = len(fills)
    if qcfg.quantize_kv:
        slots = KC.init_slot_cache(rows, heads, d, tmax, qcfg,
                                   device="cuda")
    else:
        slots = FC.init_fp_slot_cache(rows, heads, d, tmax, device="cuda")
    for s, n in enumerate(fills):
        if qcfg.quantize_kv:
            one = KC.init_layer_cache(1, heads, d, tmax, qcfg,
                                      device="cuda")
        else:
            one = FC.init_fp_cache(1, heads, d, tmax, device="cuda")
        kv = [torch.randn((1, heads, n, d), generator=gen, device="cuda"
                          ).to(torch.bfloat16) for _ in range(2)]
        if n > 1:
            if qcfg.quantize_kv:
                KC.prefill_ingest(one, kv[0][:, :, :-1], kv[1][:, :, :-1],
                                  qcfg)
            else:
                FC.fp_append(one, kv[0][:, :, :-1], kv[1][:, :, :-1])
        if n:
            if qcfg.quantize_kv:
                KC.decode_append(one, kv[0][:, :, -1:], kv[1][:, :, -1:],
                                 qcfg)
            else:
                FC.fp_append(one, kv[0][:, :, -1:], kv[1][:, :, -1:])
        KC.write_slot(slots, s, one)
    return slots


def _close(got, want, what):
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-5, (what, err)


# fills of 8 rows and the bound: the contract holds (n_v_quant + W <=
# t_bound) on every row, or is violated on rows past it
TB_CASES = [((1, 100, 255, 256, 257, 300, 383, 0), 512, True),
            ((1, 137, 500, 640, 1000, 1153, 1280, 0), 1536, True),
            ((1, 137, 500, 640, 1000, 1153, 1280, 0), 2048, True),
            ((1, 137, 500, 640, 1000, 1153, 1280, 0), 768, False)]


@pytest.mark.parametrize("fills,tb,holds", TB_CASES)
@pytest.mark.parametrize("bits", [2, 4])
def test_fused_decode_rows_t_bound(cuda, fills, tb, holds, bits):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(tb + bits)
    qcfg = QuantConfig(bits, bits, 32, 128, v_flush=128)
    c = _slot_cache(gen, qcfg, fills)
    q = torch.randn((len(fills), 8, 4, 128), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win, counts)
    kw = dict(group_size=32, k_bits=bits, v_bits=bits,
              lo=torch.tensor([0, 3, 0, 40, 0, 0, 7, 0], device="cuda",
                              dtype=torch.int32))
    got = FR.fused_decode_attention(*args, t_bound=tb, **kw)
    _close(got, FR.fused_decode_attention_plain(*args, t_bound=tb, **kw),
           f"rows t_bound={tb}")
    assert torch.equal(got, FR.fused_decode_attention(*args, t_bound=tb,
                                                      **kw))
    full = FR.fused_decode_attention(*args, **kw)
    assert torch.equal(got, full) == holds


@pytest.mark.parametrize("fills,tb,holds", TB_CASES)
@pytest.mark.parametrize("sw", [None, 300])
def test_fp_decode_rows_t_bound(cuda, fills, tb, holds, sw):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(tb)
    c = _slot_cache(gen, FP16, fills)
    q = torch.randn((len(fills), 8, 4, 128), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    kw = dict(sliding_window=sw, pad_len=torch.tensor(
        [0, 3, 0, 40, 0, 0, 7, 0], device="cuda", dtype=torch.int32))
    got = FD.fp_decode_attention_kernel(q, c.k, c.v, c.length, t_bound=tb,
                                        **kw)
    _close(got, FD.fp_decode_attention_plain(q, c.k, c.v, c.length,
                                             t_bound=tb, **kw),
           f"fp t_bound={tb}")
    full = FD.fp_decode_attention_kernel(q, c.k, c.v, c.length, **kw)
    # rows past the bound differ (the bound truncates them)
    assert torch.equal(got, full) == (holds or max(fills) <= tb)


def test_violated_fill_bound_raises(cuda):
    """A fill bound below the live fill raises under a checked call, on
    device counters (read back when the call returns) and host ints."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c = _slot_cache(gen, KIVI, (700, 700))
    q = torch.randn((2, 16, 1, 128), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    call = guards.checked_call(decode_attention)
    call(q, c, KIVI, fill_bound=700)
    with pytest.raises(guards.GuardError, match="t_bound violated"):
        call(q, c, KIVI, fill_bound=0)
    decode_attention(q, c, KIVI, fill_bound=0)     # unchecked: no raise


def _prefix_run(eng, path, snap, sampled):
    toks = _tokens(5, (B, 96))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    kw = dict(temperature=0.8, top_p=0.9, generator=gen) if sampled else {}
    if path == "prefix":
        return eng.generate(toks, NEW, prefix=snap, **kw)
    if path == "ragged":
        return eng.generate(toks, NEW, prefix=snap,
                            suffix_lens=[24, 50, 96, 70], **kw)
    if path == "stream":
        import numpy as np
        return torch.from_numpy(np.concatenate(list(eng.generate_stream(
            toks, NEW, prefix=snap, segment=16, **kw)), 1))
    return eng.generate_beam(toks[:2], NEW, num_beams=2,
                             prefix=snap if path == "beam-prefix" else None)


@pytest.mark.parametrize("path,sampled", [
    ("prefix", False), ("prefix", True), ("ragged", False),
    ("stream", False), ("stream", True), ("beam", False),
    ("beam-prefix", False)])
def test_prefix_paths_graph_matches_eager(cuda, path, sampled):
    """A 300-token prefix (44 keys in the window), 96-token suffixes: the
    replayed steps (decode, teacher-forced decode, beam with its reorder)
    against the same bodies run eagerly and under debug=True."""
    outs = []
    for kw in (dict(), dict(graphs=False), dict(debug=True)):
        eng = _engine(KIVI, **kw)
        snap = eng.prefill_prefix(_tokens(6, (PROMPT,)))
        outs.append(_prefix_run(eng, path, snap, sampled).cpu())
        if not kw:
            again = _prefix_run(eng, path, snap, sampled).cpu()
            assert torch.equal(again, outs[0])     # replays only
    assert torch.equal(outs[0], outs[1]), (outs[0] != outs[1]).nonzero()[:4]
    assert torch.equal(outs[2], outs[1]), (outs[2] != outs[1]).nonzero()[:4]


@pytest.mark.parametrize("bits", [2, 16])
def test_batcher_prefix_graph_matches_eager(cuda, bits):
    """Requests behind two prefixes (one an extension of the other)
    through a PrefixCache, chunks of 128 and tails, half sampled: the
    replayed tail and decode steps give the eager body's tokens."""
    from kivi_tpu_torch.serving.prefix_cache import PrefixCache
    qcfg = KIVI if bits == 2 else FP16
    system = _tokens(7, (400,)).tolist()
    results = []
    for graphs in (True, False):
        pc = PrefixCache(Engine(CFG, qcfg, _params(), max_seq_len=TMAX,
                                batch_size=1, device="cuda"))
        bat = ContinuousBatcher(CFG, qcfg, _params(), num_slots=3,
                                max_seq_len=TMAX, device="cuda",
                                prefill_chunk=128, prefix_cache=pc)
        if not graphs:
            bat.graphs = None
        reqs = _requests(9, 6)
        for i, r in enumerate(reqs):
            r.prompt = r.prompt[:20 + 37 * i]
            r.prefix_tokens = system if i % 2 else system[:300]
        res = bat.run(reqs)
        assert (pc.misses, pc.extends, pc.hits) == (1, 1, 4)
        results.append({u: r.tokens for u, r in res.items()})
    assert results[0] == results[1]


def test_tracer_through_replayed_graphs(cuda):
    """With the tracer on (utils/profiling.py), the batcher's and the
    engine's replayed steps give the tokens of the tracer off; a capture
    is one `graphs.capture` span per key, a replay none; the engine's
    device spans read a device time, and no span sits inside a body."""
    from kivi_tpu_torch.utils import profiling as P
    toks = _tokens(4, (B, PROMPT))
    results = []
    for on in (False, True):
        P.drain()
        (P.enable if on else P.disable)()
        try:
            bat = ContinuousBatcher(CFG, KIVI, _params(), num_slots=3,
                                    max_seq_len=TMAX, device="cuda",
                                    prompt_buckets=(128, 256, 512))
            res = bat.run(_requests(11, 8))
            eng = _engine(KIVI)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(5)
            first = eng.generate(toks, NEW, temperature=0.8, top_p=0.9,
                                 generator=gen)
            again = eng.generate(toks, NEW)
        finally:
            P.disable()
        spans = P.drain()
        results.append(({u: r.tokens for u, r in res.items()}, first,
                         again))
        if on:
            caps = [s.attrs["key"] for s in spans
                    if s.name == "graphs.capture"]
            assert len(caps) == len(set(caps)) == len(bat.graphs) + 2
            dev = [s for s in spans if s.name in (
                "engine.ingest", "engine.decode")]
            assert len(dev) == 4 and all(s.device_ms > 0 for s in dev)
            assert sum(s.name == "batcher.decode" for s in spans) > 0
        else:
            assert spans == []
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])
    assert torch.equal(results[0][2], results[1][2])
