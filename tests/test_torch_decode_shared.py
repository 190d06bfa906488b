"""The shared-prefix decode route on the CPU (kernels/decode_prefix.py):

  * its plain version (decode_prefix_plain over row 0's copy of the
    shared positions, then fused_decode_attention_plain(prefix=) over
    each row's own positions) against fused_decode_attention_plain over
    the same caches fanned out from one snapshot: r 1 and 4, bf16 and
    f32 scales, the shared bound at 0, on a split boundary and inside a
    split, rows whose own positions straddle n_v_quant and n_k_quant, a
    row whose key window is empty, and a sliding window's lower bound
    below, inside and past the shared positions.  Both compute in f32
    from the same inputs and differ in summation order only: within
    1e-5 of the output's largest value;
  * Engine.generate(prefix=) and generate_stream(prefix=) take the route
    (the batch has more than one row) and their tokens equal the JAX
    engine's, as tests/test_torch_prefix.py holds them;
  * the `engine.decode` span's `shared` attribute, and every other
    caller (generate without a prefix or at batch 1, beam search behind
    a prefix, the batcher and its PrefixCache, the fp16 cache) never
    reaching the route.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.core import attention as ATT
from kivi_tpu_torch.kernels import decode_prefix as DPX
from kivi_tpu_torch.kernels import fused_decode as FR
from kivi_tpu_torch.kernels.fused_decode_wide import SPLIT
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import Engine
from kivi_tpu_torch.serving.prefix_cache import PrefixCache
from kivi_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

H, D, TMAX, W, VF = 2, 32, 1024, 64, 32


def _fanned(doc, own, sdt, seed):
    """A slot cache fanned out from one snapshot of `doc` tokens (W 64,
    v_flush 32: n_v_quant trails n_k_quant), row b then extended by
    own[b][0] tokens and own[b][1] decode appends.  Returns (snapshot,
    slot cache)."""
    qcfg = QuantConfig(2, 2, 32, W, v_flush=VF, scale_dtype=sdt)
    g = torch.Generator().manual_seed(seed)

    def kv(n):
        return (torch.randn((1, H, n, D), generator=g),
                torch.randn((1, H, n, D), generator=g))

    snap = KC.init_layer_cache(1, H, D, TMAX, qcfg, torch.float32, "cpu")
    KC.prefill_ingest(snap, *kv(doc), qcfg)
    slots = KC.init_slot_cache(len(own), H, D, TMAX, qcfg, torch.float32,
                               "cpu")
    for b, (n, steps) in enumerate(own):
        one = KC.init_layer_cache(1, H, D, TMAX, qcfg, torch.float32, "cpu")
        KC.broadcast_rows_into(one, snap)
        if n:
            KC.prefill_extend(one, *kv(n), qcfg, doc)
        for _ in range(steps):
            KC.decode_append(one, *kv(1), qcfg)
        KC.write_slot(slots, b, one)
    return snap, slots


# document tokens -> the shared positions the snapshot gives (W 64,
# v_flush 32, group 32): on a split boundary (256, 512) or inside one
DOCS = {250: 192, 300: 256, 400: 320, 560: 512}


@pytest.mark.parametrize("lo", [None, "swa"])
@pytest.mark.parametrize("doc", sorted(DOCS))
@pytest.mark.parametrize("sdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("r", [1, 4])
def test_route_plain_equals_rows_plain(r, sdt, doc, lo):
    """The route's plain version against fused_decode_attention_plain on
    caches fanned out from one snapshot (module docstring)."""
    # an empty key window, short and long own parts, flushes of both
    # windows past the snapshot
    own = [((-doc) % W or W, 0), (1, 0), (5, 3), (40, 17), (64, 70)]
    snap, c = _fanned(doc, own, sdt, doc + r)
    shared = DPX.shared_positions(snap.n_k_quant, snap.n_v_quant, 32)
    assert shared == DOCS[doc]
    nkq, nkw, nvq = (c.n_k_quant.tolist(), c.n_k_win.tolist(),
                     c.n_v_quant.tolist())
    assert 0 in nkw and any(a != b for a, b in zip(nkq, nvq))
    assert all(min(a, b) >= shared for a, b in zip(nkq, nvq))
    q = torch.randn((len(own), H, r, D),
                    generator=torch.Generator().manual_seed(doc))
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win, counts)
    bound = None
    if lo == "swa":   # below, inside and past the shared positions
        bound = torch.tensor([0, shared // 2, shared + 3, shared - 1,
                              int(c.seq_len[4]) + 1], dtype=torch.int32)
    kw = dict(group_size=32, k_bits=2, v_bits=2, lo=bound)
    want = FR.fused_decode_attention_plain(*args, **kw)
    for s in (shared, 0):
        got = DPX.shared_decode_attention(*args, shared=s, **kw)
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (s, err)
    if bound is not None:
        assert (want[4] == 0).all()


def test_route_plain_under_t_bound_and_prefix_splits():
    """Under a fill bound, and with the prefix state cut into several
    splits (as the kernel returns it), the merge gives the same."""
    own = [(8, 2), (30, 40), (64, 5)]
    snap, c = _fanned(560, own, "float32", 3)
    shared = DPX.shared_positions(snap.n_k_quant, snap.n_v_quant, 32)
    q = torch.randn((3, H, 4, D), generator=torch.Generator().manual_seed(1))
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    arrays = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
              c.v_mn)
    kw = dict(group_size=32, k_bits=2, v_bits=2)
    tb = 3 * SPLIT
    want = FR.fused_decode_attention_plain(*arrays, c.k_win, c.v_win,
                                           counts, t_bound=tb, **kw)
    parts = [DPX.decode_prefix_plain(q, *arrays[1:], shared=shared, **kw)]
    # the same state as two splits: [0, 256) and [256, shared)
    lo_half = torch.full((3,), 256, dtype=torch.int32)
    first = DPX.decode_prefix_plain(q, *arrays[1:], shared=256, **kw)
    second = DPX.decode_prefix_plain(q, *arrays[1:], shared=shared,
                                     lo=lo_half, **kw)
    parts.append(tuple(torch.cat([a, b], dim=1)
                       for a, b in zip(first, second)))
    for prefix in parts:
        got = FR.fused_decode_attention_plain(
            *arrays, c.k_win, c.v_win, counts, t_bound=tb, prefix=prefix,
            shared=shared, **kw)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_shared_positions_and_split_plan():
    """The shared bound rounds down to whole groups and chunks; the pass's
    split plan covers the chunks, at docqa's shape in 11 splits of 17
    chunks (264 blocks: two waves on 132 SMs)."""
    assert DPX.shared_positions(11904, 11904, 32) == 11904
    assert DPX.shared_positions(12032, 11904, 32) == 11904
    assert DPX.shared_positions(100, 200, 32) == 64
    assert DPX.shared_positions(63, 200, 32) == 0
    assert DPX.shared_positions(300, 300, 128) == 256
    assert DPX.split_plan(11904, 384, 8, 132) == (17, 11)
    for shared, rows, heads in ((64, 1, 1), (1920, 32, 8), (11904, 96, 8),
                                (4096, 2048, 32)):
        cps, n = DPX.split_plan(shared, rows, heads, 132)
        assert (n - 1) * cps * 64 < shared <= n * cps * 64


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TQ = QuantConfig(2, 2, 32, 32, v_flush=32, scale_dtype="float32")


@pytest.fixture(autouse=True)
def _exact_matmul():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", torch.float32)


def _engines(bits, batch):
    kw = dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=32,
              v_flush=32, scale_dtype="float32")
    jp, tp = _params()
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**kw), params=jp,
                   max_seq_len=256, batch_size=batch, impl="jnp")
    jeng.cache_dtype = jnp.float32
    teng = Engine(cfg=tiny_config(), qcfg=QuantConfig(**kw), params=tp,
                  max_seq_len=256, batch_size=batch, device="cpu",
                  cache_dtype=torch.float32)
    return jeng, teng


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape)


@pytest.fixture
def route_calls(monkeypatch):
    """Counts the decode attention calls that take the route (one a
    layer a step)."""
    calls = []
    orig = ATT.shared_decode_attention

    def counted(*a, **kw):
        calls.append(kw["shared"])
        return orig(*a, **kw)

    monkeypatch.setattr(ATT, "shared_decode_attention", counted)
    return calls


@pytest.mark.parametrize("bits", [2, 4])
def test_generate_prefix_takes_route_and_matches_jax(bits, route_calls):
    """A 150-token prefix (128 shared positions) behind 2 suffixes of 30
    tokens, 40 new: the route serves every decode step of every layer,
    and the tokens equal the JAX engine's."""
    jeng, teng = _engines(bits, 2)
    pre, suf = _toks(31 + bits, (150,)), _toks(32 + bits, (2, 30))
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    ts = teng.prefill_prefix(torch.from_numpy(pre))
    want = np.asarray(jeng.generate(jnp.asarray(suf, jnp.int32), 40,
                                    prefix=js))
    got = teng.generate(torch.from_numpy(suf), 40, prefix=ts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert route_calls == [128] * (tiny_config().num_layers * 39)


def test_generate_stream_prefix_takes_route_and_matches_jax(route_calls):
    """generate_stream(prefix=) in segments of 7: the blocks joined equal
    the JAX engine's generate, through the route at every step."""
    jeng, teng = _engines(2, 3)
    pre, suf = _toks(41, (150,)), _toks(42, (3, 20))
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    ts = teng.prefill_prefix(torch.from_numpy(pre))
    want = np.asarray(jeng.generate(jnp.asarray(suf, jnp.int32), 30,
                                    prefix=js))
    blocks = list(teng.generate_stream(torch.from_numpy(suf), 30, segment=7,
                                       prefix=ts))
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1), want)
    assert route_calls == [128] * (tiny_config().num_layers * 29)


def test_ragged_prefix_takes_route_and_matches_jax(route_calls):
    """Ragged suffixes behind the prefix (teacher-forced rows) through the
    route: tokens equal the JAX engine's."""
    jeng, teng = _engines(2, 2)
    pre, suf = _toks(51, (150,)), _toks(52, (2, 24))
    lens = [9, 24]
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    ts = teng.prefill_prefix(torch.from_numpy(pre))
    want = np.asarray(jeng.generate(jnp.asarray(suf, jnp.int32), 12,
                                    prefix=js, suffix_lens=lens))
    got = teng.generate(torch.from_numpy(suf), 12, prefix=ts,
                        suffix_lens=lens)
    np.testing.assert_array_equal(got.numpy(), want)
    assert route_calls and set(route_calls) == {128}


@pytest.fixture
def tracer():
    P.drain()
    P.enable()
    try:
        yield P
    finally:
        P.disable()
        P.drain()


def _decode_shared(spans):
    return [s.attrs["shared"] for s in spans if s.name == "engine.decode"]


def test_decode_span_shared(tracer, route_calls):
    """`engine.decode`'s `shared`: the positions read once a layer behind
    the prefix, 0 without one and at batch 1; no batcher step (its
    PrefixCache admissions included) reaches the route."""
    _, teng = _engines(2, 2)
    pre, suf = _toks(61, (150,)), _toks(62, (2, 10))
    snap = teng.prefill_prefix(torch.from_numpy(pre))
    teng.generate(torch.from_numpy(suf), 6, prefix=snap)
    assert _decode_shared(tracer.drain()) == [128]
    teng.generate(torch.from_numpy(suf), 6)
    assert _decode_shared(tracer.drain()) == [0]
    one = Engine(teng.cfg, teng.qcfg, teng.params, 256, 1, device="cpu",
                 cache_dtype=torch.float32)
    one.generate(torch.from_numpy(suf[:1]), 6,
                 prefix=one.prefill_prefix(torch.from_numpy(pre)))
    assert _decode_shared(tracer.drain()) == [0]
    n = len(route_calls)
    bat = ContinuousBatcher(tiny_config(), teng.qcfg, teng.params,
                            num_slots=2, max_seq_len=256, device="cpu",
                            prompt_buckets=(32, 64),
                            prefix_cache=PrefixCache(teng),
                            cache_dtype=torch.float32)
    bat.run([Request(uid=u, prompt=_toks(63 + u, (12,)).tolist(),
                     max_new_tokens=5,
                     prefix_tokens=pre.tolist() if u else None)
             for u in range(3)])
    spans = tracer.drain()
    assert _decode_shared(spans) == []
    assert any(s.name == "batcher.step" for s in spans)
    assert len(route_calls) == n == tiny_config().num_layers * 5


def test_other_callers_keep_row_6(route_calls):
    """Beam search behind a prefix, generate without one, the fp16 cache
    behind a prefix, and a direct decode: none reaches the route."""
    _, teng = _engines(2, 4)
    pre, suf = _toks(71, (150,)), _toks(72, (2, 10))
    snap = teng.prefill_prefix(torch.from_numpy(pre))
    teng.generate_beam(torch.from_numpy(suf), 5, num_beams=2, prefix=snap)
    teng.generate(torch.from_numpy(np.tile(suf, (2, 1))), 5)
    _, f = _engines(16, 2)
    f.generate(torch.from_numpy(suf), 5,
               prefix=f.prefill_prefix(torch.from_numpy(pre)))
    assert route_calls == []
    # the engine's own caches behind the prefix, decoded by a caller that
    # passes no bound
    pr = teng._ingest_prompt(torch.from_numpy(np.tile(suf, (2, 1))), 5,
                             prefix=snap)
    assert pr.shared == 128
    teng.decode(pr.first, pr.pos, pr.caches, steps=4, prompt_len=pr.Tp)
    assert route_calls == []


def test_decode_attention_shared_needs_row_counters():
    """A host-int cache refuses shared= (the route reads per-row device
    counters)."""
    cfg = tiny_config()
    c = modeling.init_caches(cfg, TQ, 2, 256, torch.float32, "cpu")[0]
    q = torch.zeros((2, cfg.num_heads, 1, cfg.head_dim))
    with pytest.raises(ValueError, match="per-row"):
        ATT.decode_attention(q, c, TQ, shared=64)
