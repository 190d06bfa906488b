"""The port's prefix serving (kivi_tpu_torch.serving.engine, CPU) against
the JAX package's Engine(impl="jnp"), mirroring tests/test_prefix_cache.py
(engine part), tests/test_prefix_ragged.py and tests/test_checkpoint.py's
snapshot round trip: the cache fan-out and reorder, `prefill_prefix`,
`extend`, `generate(prefix=, suffix_lens=)` and the snapshot on disk in
the port's own format.

Tolerance: greedy and teacher-forced tokens exactly equal; snapshot codes
>= 99.9% equal, their scales, mins and windows within SNAP_ULPS = 12 ulps
of each field's largest magnitude: a snapshot comes out of a forward,
whose f32 keys and values the two libraries sum in different orders, as
tests/test_torch_model.py's caches (the quantizer alone is held bit for
bit by tests/test_torch_cache.py).  The largest gap measured over this
file's snapshots is 9 such ulps (2.1e-6 absolute, the fp cache's keys;
scales 7, mins 9, windows 8); per element it reaches thousands of ulps
only at values near 0, where the keys cancel.  The suffix extend's and
the teacher-forced logits within 1e-4 (f32 weights over f32 caches on
both sides); the fp16 cache's within 2e-2 (the JAX fp decode oracle rounds to bf16,
tests/test_torch_engine.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JKC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import (Engine, PrefixSnapshot,
                                           load_prefix_snapshot,
                                           save_prefix_snapshot)

torch.set_num_threads(2)

TMAX = 256


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


def _kw(bits, vf=32):
    return dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=32,
                v_flush=vf, scale_dtype="float32")


def _engines(bits, batch, vf=32, debug=False):
    jp, tp = _params()
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**_kw(bits, vf)),
                   params=jp, max_seq_len=TMAX, batch_size=batch, impl="jnp")
    jeng.cache_dtype = jnp.float32
    teng = Engine(cfg=tiny_config(), qcfg=QuantConfig(**_kw(bits, vf)),
                  params=tp, max_seq_len=TMAX, batch_size=batch,
                  device="cpu", cache_dtype=torch.float32, debug=debug)
    return jeng, teng


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _tensors(cache):
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)}


def _to_jax(cache):
    """A port cache's bytes as the JAX package's cache of the same kind."""
    from kivi_tpu.cache.fp_cache import FpLayerCache as JFp
    kw = {}
    for f in dataclasses.fields(cache):
        x = getattr(cache, f.name)
        if not isinstance(x, torch.Tensor):
            kw[f.name] = jnp.int32(x)
        else:
            a = x.numpy()
            kw[f.name] = jnp.asarray(a.view(np.uint32) if "codes" in f.name
                                     else a)
    return (JKC.KiviLayerCache if isinstance(cache, KC.KiviLayerCache)
            else JFp)(**kw)


SNAP_ULPS = 12


def _assert_caches_close(got, want, what):
    """Port caches against JAX caches: counters equal, codes >= 99.9%
    equal, scales, mins and windows within SNAP_ULPS ulps of the field's
    largest magnitude."""
    for g, w in zip(got, want):
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if not isinstance(a, torch.Tensor):
                assert a == int(b), (what, f.name)
            elif "codes" in f.name:
                assert (_np(a) == _np(b)).mean() >= 0.999, (what, f.name)
            else:
                b = np.asarray(b)
                ulp = np.spacing(np.abs(b).max().astype(np.float32))
                np.testing.assert_allclose(_np(a), b, rtol=0,
                                           atol=SNAP_ULPS * ulp,
                                           err_msg=f"{what} {f.name}")


# ---------------------------------------------------------------------------
# fan-out and reorder (kivi_tpu/cache/kivi_cache.py:274-284, 525-538)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 16])
def test_broadcast_and_reorder_match_jax(bits):
    """broadcast_rows / reorder against the JAX functions on a prefilled
    cache, and their in-place forms: every tensor keeps its address, the
    counters of the copy are its own (a fresh host int, a cloned device
    row; tests/test_prefix_cache.py:486), and the gather below a bound
    equals the full gather when the rows agree past it."""
    jeng, teng = _engines(bits, 1)
    pre = _toks(0, (50,))
    jsnap = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    tsnap = teng.prefill_prefix(torch.from_numpy(pre))
    _assert_caches_close(tsnap.caches, jsnap.caches, "snapshot")
    c = tsnap.caches[0]
    jc = _to_jax(c)
    wide = KC.broadcast_rows(c, 4)
    jwide = JKC.broadcast_rows(jc, 4)
    for n, x in _tensors(wide).items():
        assert x.shape[0] == 4
        np.testing.assert_array_equal(_np(x), _np(getattr(jwide, n)))
        assert x.data_ptr() != getattr(c, n).data_ptr()
    assert wide.seq_len == c.seq_len == 50
    # device counters: repeated into fresh storage
    dev = KC.broadcast_rows(c, 1)
    KC.counters_to_device([dev], names=("length",) if bits == 16 else
                          KC._COUNTERS)
    dev4 = KC.broadcast_rows(dev, 4)
    assert dev4.seq_len.tolist() == [50] * 4
    assert dev4.seq_len.data_ptr() != dev.seq_len.data_ptr()

    idx = torch.tensor([2, 2, 0, 3])
    got = KC.reorder(wide, idx)
    want = JKC.reorder(jwide, jnp.asarray(idx.numpy()))
    for n, x in _tensors(got).items():
        np.testing.assert_array_equal(_np(x), _np(getattr(want, n)))
    # in place into an engine-shaped cache of 4 rows fanned out, row 1
    # scaled (zeros stay zeros: the rows still agree past the fill)
    own = modeling.init_caches(teng.cfg, teng.qcfg, 4, TMAX, torch.float32,
                               "cpu")[0]
    KC.broadcast_rows_into(own, c)
    assert own.seq_len == 50
    for x in _tensors(own).values():
        x[1:2].mul_(3)
    ref = KC.reorder(own, idx)
    ptrs = {n: x.data_ptr() for n, x in _tensors(own).items()}
    twin = KC.reorder(own, torch.arange(4))
    KC.reorder_into(own, idx)
    KC.reorder_into(twin, idx, bound=TMAX // 2)
    for n, x in _tensors(own).items():
        assert x.data_ptr() == ptrs[n]
        np.testing.assert_array_equal(x.numpy(), getattr(ref, n).numpy())
        np.testing.assert_array_equal(getattr(twin, n).numpy(),
                                      getattr(ref, n).numpy())


def test_broadcast_into_refuses_a_foreign_snapshot():
    """A snapshot of another cache length or dtype is refused, never cast
    or cut."""
    _, teng = _engines(2, 2)
    snap = teng.prefill_prefix(torch.from_numpy(_toks(1, (40,))))
    other = Engine(cfg=teng.cfg, qcfg=teng.qcfg, params=teng.params,
                   max_seq_len=2 * TMAX, batch_size=2, device="cpu",
                   cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        other.generate(torch.from_numpy(_toks(2, (2, 5))), 3, prefix=snap)
    bf16 = Engine(cfg=teng.cfg, qcfg=teng.qcfg, params=teng.params,
                  max_seq_len=TMAX, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        bf16.generate(torch.from_numpy(_toks(2, (2, 5))), 3, prefix=snap)


# ---------------------------------------------------------------------------
# snapshots: prefill_prefix, extend (kivi_tpu/serving/engine.py:556-634)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 64])
def test_prefill_prefix_and_extend_match_jax(chunk):
    """prefill_prefix (one-shot or chunked) and extend through 2-bit: the
    snapshots' caches against the JAX package's; the token ids chain."""
    jeng, teng = _engines(2, 1)
    t0, t1 = _toks(3, (70,)), _toks(4, (45,))
    js = jeng.prefill_prefix(jnp.asarray(t0, jnp.int32), chunk_size=chunk)
    ts = teng.prefill_prefix(torch.from_numpy(t0), chunk_size=chunk)
    _assert_caches_close(ts.caches, js.caches, "prefill_prefix")
    js1 = jeng.extend(js, jnp.asarray(t1, jnp.int32))
    ts1 = teng.extend(ts, torch.from_numpy(t1))
    assert ts1.length == js1.length == 115
    np.testing.assert_array_equal(ts1.tokens.numpy(), np.asarray(js1.tokens))
    _assert_caches_close(ts1.caches, js1.caches, "extend")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        teng.prefill_prefix(torch.from_numpy(t0), seq_mesh=object())


def test_extend_matches_one_shot_snapshot_fp16():
    """fp16 cache: extend(snap(t0), t1) against prefill_prefix(t0 + t1)
    to fp noise (tests/test_prefix_cache.py:231-258); the source snapshot
    is not written."""
    _, teng = _engines(16, 1)
    t0, t1 = _toks(5, (37,)), _toks(6, (45,))
    snap0 = teng.prefill_prefix(torch.from_numpy(t0))
    before = {n: x.clone() for n, x in _tensors(snap0.caches[0]).items()}
    snap1 = teng.extend(snap0, torch.from_numpy(t1))
    one = teng.prefill_prefix(torch.from_numpy(np.concatenate([t0, t1])))
    for n, x in _tensors(snap0.caches[0]).items():
        assert torch.equal(x, before[n])
    assert snap0.length == 37 and snap1.length == one.length == 82
    for a, b in zip(snap1.caches, one.caches):
        for n, x in _tensors(a).items():
            np.testing.assert_allclose(x.numpy(), getattr(b, n).numpy(),
                                       atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# generate(prefix=) (kivi_tpu/serving/engine.py:653-838)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,vf", [(2, 32), (8, 32), (4, 32)])
def test_generate_prefix_matches_jax(bits, vf):
    """generate(prefix=) through KIVI caches: greedy tokens equal the JAX
    engine's, across K and V flushes (a 70-token prefix leaves 6 keys in
    the window; 30 suffix tokens and 40 new cross both flushes); the
    suffix extend's logits within 1e-4 of JAX's."""
    jeng, teng = _engines(bits, 2, vf)
    pre, suf = _toks(7 + bits, (70,)), _toks(8 + bits, (2, 30))
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    ts = teng.prefill_prefix(torch.from_numpy(pre))
    want = np.asarray(jeng.generate(jnp.asarray(suf, jnp.int32), 40,
                                    prefix=js))
    got = teng.generate(torch.from_numpy(suf), 40, prefix=ts)
    assert got.dtype == torch.int32 and got.shape == (2, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    jc = [JKC.broadcast_rows(c, 2) for c in js.caches]
    jlog, _ = jeng._extend_call(jeng.params, jnp.asarray(suf, jnp.int32),
                                jc, js.length)
    pr = teng._ingest_prompt(torch.from_numpy(suf), 4, prefix=ts)
    np.testing.assert_allclose(pr.logits.numpy(), np.asarray(jlog),
                               atol=1e-4, rtol=0)


def test_generate_prefix_fp16_matches_full_prompt_and_jax():
    """fp16 cache: generate(prefix=snap, suffix) equals generate(prefix +
    suffix) (the extend path is exact when nothing is quantized), and the
    suffix extend's logits lie within 2e-2 of the JAX engine's."""
    jeng, teng = _engines(16, 2)
    pre, suf = _toks(9, (30,)), _toks(10, (2, 11))
    full = np.concatenate([np.broadcast_to(pre, (2, 30)), suf], 1)
    want = teng.generate(torch.from_numpy(full), 12)
    snap = teng.prefill_prefix(torch.from_numpy(pre))
    got = teng.generate(torch.from_numpy(suf), 12, prefix=snap)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    jlog, _ = jeng._extend_call(jeng.params, jnp.asarray(suf, jnp.int32),
                                [JKC.broadcast_rows(c, 2) for c in js.caches],
                                30)
    pr = teng._ingest_prompt(torch.from_numpy(suf), 4, prefix=snap)
    np.testing.assert_allclose(pr.logits.numpy(), np.asarray(jlog),
                               atol=2e-2, rtol=0)


def test_prefix_penalty_sees_prefix_tokens():
    """The penalty mask covers the prefix's tokens: the penalized prefix
    run equals the penalized full-prompt run (fp16), and the 2-bit
    penalized prefix run equals the JAX engine's."""
    _, teng = _engines(16, 1)
    pre, suf = _toks(11, (25,)), _toks(12, (1, 6))
    full = np.concatenate([pre[None], suf], 1)
    want = teng.generate(torch.from_numpy(full), 10, repetition_penalty=1.5)
    got = teng.generate(torch.from_numpy(suf), 10, repetition_penalty=1.5,
                        prefix=teng.prefill_prefix(torch.from_numpy(pre)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jeng, teng = _engines(2, 1)
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    want = np.asarray(jeng.generate(jnp.asarray(suf, jnp.int32), 10,
                                    prefix=js, repetition_penalty=1.5))
    got = teng.generate(torch.from_numpy(suf), 10, repetition_penalty=1.5,
                        prefix=teng.prefill_prefix(torch.from_numpy(pre)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefix_2bit_broadcasts_and_is_not_consumed():
    """2-bit: rows with one suffix decode alike (every row got the same
    prefix), and two generates from one snapshot agree; the snapshot's
    tensors are not written (tests/test_prefix_cache.py:298-320)."""
    _, teng = _engines(2, 2)
    snap = teng.extend(teng.prefill_prefix(torch.from_numpy(_toks(13, (33,)))),
                       torch.from_numpy(_toks(14, (19,))))
    before = [{n: x.clone() for n, x in _tensors(c).items()}
              for c in snap.caches]
    suffix = torch.from_numpy(np.broadcast_to(_toks(15, (7,)), (2, 7)).copy())
    out = teng.generate(suffix, 15, prefix=snap)
    assert torch.equal(out[0], out[1])
    assert torch.equal(out, teng.generate(suffix, 15, prefix=snap))
    for c, b in zip(snap.caches, before):
        for n, x in _tensors(c).items():
            assert torch.equal(x, b[n]), n


def test_stored_snapshot_unchanged_by_every_reader():
    """One stored snapshot read by extend, generate(prefix=), a ragged
    generate, a beam search, a stream and a batcher admission (chunk and
    tail): its tensors and counters end as they began."""
    _, teng = _engines(2, 2)
    snap = teng.prefill_prefix(torch.from_numpy(_toks(16, (60,))))
    before = [({n: x.clone() for n, x in _tensors(c).items()}, c.seq_len)
              for c in snap.caches]
    suf = torch.from_numpy(_toks(17, (2, 20)))
    teng.extend(snap, suf[0])
    teng.generate(suf, 8, prefix=snap)
    teng.generate(suf, 8, prefix=snap, suffix_lens=[11, 20])
    teng.generate_beam(suf[:1], 6, num_beams=2, prefix=snap)
    list(teng.generate_stream(suf, 8, segment=3, prefix=snap))
    _, tp = _params()
    bat = ContinuousBatcher(tiny_config(), teng.qcfg, tp, num_slots=2,
                            max_seq_len=TMAX, device="cpu", prefill_chunk=32,
                            prefix=snap, cache_dtype=torch.float32)
    bat.run([Request(uid=0, prompt=_toks(18, (45,)).tolist(),
                     max_new_tokens=4)])
    for c, (b, n) in zip(snap.caches, before):
        assert c.seq_len == n == 60
        for name, x in _tensors(c).items():
            assert torch.equal(x, b[name]), name


def test_prefix_arguments_refused():
    _, teng = _engines(2, 2)
    snap = teng.prefill_prefix(torch.from_numpy(_toks(19, (40,))))
    suf = torch.from_numpy(_toks(20, (2, 8)))
    with pytest.raises(ValueError, match="not with pad_lens"):
        teng.generate(suf, 4, prefix=snap, pad_lens=[0, 1])
    with pytest.raises(ValueError, match="prefill_chunk_size"):
        teng.generate(suf, 4, prefix=snap, prefill_chunk_size=32)
    with pytest.raises(ValueError, match="needs prefix"):
        teng.generate(suf, 4, suffix_lens=[3, 8])
    with pytest.raises(ValueError, match="suffix_lens"):
        teng.generate(suf, 4, prefix=snap, suffix_lens=[0, 8])


# ---------------------------------------------------------------------------
# ragged suffixes (tests/test_prefix_ragged.py)
# ---------------------------------------------------------------------------

def test_ragged_equal_lens_is_the_normal_path():
    _, teng = _engines(2, 2)
    snap = teng.prefill_prefix(torch.from_numpy(_toks(21, (33,))))
    suf = torch.from_numpy(_toks(22, (2, 13)))
    want = teng.generate(suf, 9, prefix=snap)
    got = teng.generate(suf, 9, prefix=snap, suffix_lens=[13, 13])
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits,lens,new", [(2, [11, 20], 8),
                                           (4, [3, 17, 9], 12),
                                           (2, [30, 5, 5], 40)])
def test_ragged_matches_jax(bits, lens, new):
    """Ragged suffixes through the teacher-forced decode: tokens equal the
    JAX engine's (the same extend of min(lens), teacher steps and
    realignment), across flushes; the last step's teacher-forced logits
    of a row that was teacher-forced throughout (with one new token)
    within 1e-4 of a JAX run fed the same tokens."""
    B = len(lens)
    jeng, teng = _engines(bits, B)
    pre, suf = _toks(23 + bits, (40,)), _toks(24 + bits, (B, max(lens)))
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    ts = teng.prefill_prefix(torch.from_numpy(pre))
    want = np.asarray(jeng.generate(jnp.asarray(suf, jnp.int32), new,
                                    prefix=js, suffix_lens=lens))
    got = teng.generate(torch.from_numpy(suf), new, prefix=ts,
                        suffix_lens=lens)
    np.testing.assert_array_equal(got.numpy(), want)
    # teacher-forced logits: the longest row's after its whole tail,
    # against JAX decode steps fed the same suffix tokens
    teng.generate(torch.from_numpy(suf), 1, prefix=ts, suffix_lens=lens)
    Tmin, L, b = min(lens), max(lens) - min(lens), int(np.argmax(lens))
    jc = [JKC.broadcast_rows(c, B) for c in js.caches]
    _, jc = jeng._extend_call(jeng.params, jnp.asarray(suf[:, :Tmin],
                                                       jnp.int32), jc, 40)
    for j in range(L):
        jlog, jc = jeng._decode(
            jeng.params, jnp.asarray(suf[:, Tmin + j:Tmin + j + 1], jnp.int32),
            jnp.full((B, 1), 40 + Tmin + j, jnp.int32), jc, None)
    np.testing.assert_allclose(teng._dec.logits[b].numpy(),
                               np.asarray(jlog)[b], atol=1e-4, rtol=0)


def test_ragged_fp16_matches_per_row_batch_1():
    """fp16 cache: the teacher-forced split is exact, so each row equals a
    batch-1 prefix run of its own suffix."""
    _, teng = _engines(16, 3)
    pre, suf = _toks(25, (30,)), _toks(26, (3, 17))
    lens = [9, 17, 12]
    got = teng.generate(torch.from_numpy(suf), 10, suffix_lens=lens,
                        prefix=teng.prefill_prefix(torch.from_numpy(pre)))
    _, eng1 = _engines(16, 1)
    snap1 = eng1.prefill_prefix(torch.from_numpy(pre))
    for b, n in enumerate(lens):
        want = eng1.generate(torch.from_numpy(suf[b:b + 1, :n]), 10,
                             prefix=snap1)
        np.testing.assert_array_equal(got[b:b + 1].numpy(), want.numpy(),
                                      err_msg=f"row {b} len {n}")


def test_ragged_sampling_topup_and_debug():
    """Penalty and top-k sampling through the ragged path, a batch topped
    up from 2 rows to 3, and debug=True (every teacher-forced step a
    checked call) giving the graphs-free run's tokens."""
    _, teng = _engines(2, 3)
    _, dbg = _engines(2, 3, debug=True)
    pre, suf = _toks(27, (24,)), _toks(28, (2, 15))
    outs = []
    for eng in (teng, dbg):
        gen = torch.Generator().manual_seed(3)
        outs.append(eng.generate(
            torch.from_numpy(suf), 6, suffix_lens=[7, 15], temperature=0.8,
            top_k=8, repetition_penalty=1.2, generator=gen,
            prefix=eng.prefill_prefix(torch.from_numpy(pre))))
    assert outs[0].shape == (2, 6)
    assert ((outs[0] >= 0) & (outs[0] < 256)).all()
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the snapshot on disk (tests/test_checkpoint.py:59-117, the port's format)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 16])
def test_prefix_snapshot_roundtrip(tmp_path, bits):
    _, teng = _engines(bits, 2)
    snap = teng.prefill_prefix(torch.from_numpy(_toks(29, (70,))))
    save_prefix_snapshot(str(tmp_path / "snap"), snap)
    back = load_prefix_snapshot(str(tmp_path / "snap"), device="cpu")
    assert isinstance(back, PrefixSnapshot) and back.length == 70
    assert torch.equal(back.tokens, snap.tokens)
    for a, b in zip(snap.caches, back.caches):
        assert type(a) is type(b) and a.seq_len == b.seq_len
        for n, x in _tensors(a).items():
            y = getattr(b, n)
            assert x.dtype == y.dtype and torch.equal(x, y), n
    suf = torch.from_numpy(_toks(30, (2, 9)))
    assert torch.equal(teng.generate(suf, 8, prefix=back),
                       teng.generate(suf, 8, prefix=snap))
