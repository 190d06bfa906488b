"""The port's streaming generation (Engine.generate_stream, CPU) against
its generate() and the JAX package's, mirroring tests/test_streaming.py.

Greedy streams equal the JAX engine's generate() token for token
(segmenting changes the dispatch, not the math: the segment-boundary K
flush keeps every segment on the schedule one decode would run); EOS
rows pad alike and the stream may stop early; a sampled stream equals
generate()'s tokens bit for bit with one torch.Generator seed, as the
JAX stream keeps its rng chain in step.  Tolerance: tokens equal (f32
weights over f32 caches, tests/test_torch_engine.py).
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
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving import engine as TE
from kivi_tpu_torch.serving.engine import Engine

torch.set_num_threads(2)

KW = dict(k_bits=2, v_bits=2, group_size=32, residual_length=32,
          scale_dtype="float32")


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


def _engines(batch=2, debug=False):
    jp, tp = _params()
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**KW), params=jp,
                   max_seq_len=256, batch_size=batch, impl="jnp")
    jeng.cache_dtype = jnp.float32
    teng = Engine(cfg=tiny_config(), qcfg=QuantConfig(**KW), params=tp,
                  max_seq_len=256, batch_size=batch, device="cpu",
                  cache_dtype=torch.float32, debug=debug)
    return jeng, teng


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape)


def _collect(stream):
    blocks = list(stream)
    for b in blocks:
        assert isinstance(b, np.ndarray) and b.dtype == np.int32
    return np.concatenate(blocks, axis=1), blocks


@pytest.mark.parametrize("segment", [1, 4, 5, 16])
def test_stream_matches_generate_greedy(segment):
    """20 prompt tokens leave 20 keys in the window (W 32): K and V flush
    before decode steps 12 and 44.  Segments of 1 and 4 end on step 12
    (the stream flushes K at the boundary), 5 and 16 flush inside a
    segment."""
    jeng, teng = _engines()
    toks = _toks(0, (2, 20))
    want = np.asarray(jeng.generate(jnp.asarray(toks, jnp.int32), 50))
    got, blocks = _collect(teng.generate_stream(torch.from_numpy(toks), 50,
                                                segment=segment))
    np.testing.assert_array_equal(got, want)
    assert blocks[0].shape == (2, 1)          # the time-to-first-token yield
    assert all(b.shape[1] <= segment for b in blocks[1:])


def test_stream_boundary_flushes_k_only():
    """A segment boundary where both flushes are due: the stream flushes
    K alone there, V's flush being the next schedule's step 0 (flushing
    both would leave n_v_win < 0).  33 prompt tokens and segment 31 put
    it at 33 + 31 = 64 = 2W tokens cached."""
    _, teng = _engines()
    calls = []

    def spy(caches, qcfg, k=False, v=False):
        n = caches[0].seq_len               # a host int between decodes
        calls.append((n if isinstance(n, int) else None, k, v))
        return TE.modeling.flush_caches(caches, qcfg, k=k, v=v)

    teng._flush = spy
    toks = torch.from_numpy(_toks(1, (2, 33)))
    got, _ = _collect(teng.generate_stream(toks, 70, segment=31))
    assert (64, True, False) in calls
    for c in teng._caches:          # the caches the stream decoded into
        assert 0 <= c.n_v_win <= 32 and 0 <= c.n_k_win <= 32
    _, fresh = _engines()
    np.testing.assert_array_equal(got, fresh.generate(toks, 70).numpy())


def test_stream_matches_generate_with_penalty_and_pad():
    jeng, teng = _engines()
    toks = _toks(2, (2, 24))
    kw = dict(pad_lens=[3, 9], repetition_penalty=1.6)
    want = np.asarray(jeng.generate(jnp.asarray(toks, jnp.int32), 18, **kw))
    got, _ = _collect(teng.generate_stream(torch.from_numpy(toks), 18,
                                           segment=7, **kw))
    np.testing.assert_array_equal(got, want)


def test_stream_eos_pads_and_stops_early():
    """The EOS id is taken from the model's own greedy output so that it
    fires mid-stream: rows past it emit EOS, and the stream ends early."""
    _, teng = _engines()
    toks = torch.from_numpy(_toks(3, (2, 16)))
    free = teng.generate(toks, 24).numpy()
    eos = int(free[0, 5])
    want = teng.generate(toks, 24, eos_token_id=eos).numpy()
    got, _ = _collect(teng.generate_stream(toks, 24, segment=4,
                                           eos_token_id=eos))
    n = got.shape[1]
    assert n <= 24
    np.testing.assert_array_equal(got, want[:, :n])
    assert (want[:, n:] == eos).all()


def test_stream_matches_generate_sampled():
    """temperature > 0: one generator seed, the same draws in the same
    order, the same tokens."""
    _, teng = _engines()
    toks = torch.from_numpy(_toks(5, (2, 18)))
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    want = teng.generate(toks, 37, generator=torch.Generator().manual_seed(7),
                         **kw).numpy()
    got, _ = _collect(teng.generate_stream(
        toks, 37, segment=6, generator=torch.Generator().manual_seed(7), **kw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("debug", [False, True])
def test_stream_with_prefix_matches_generate(debug):
    """A stream behind a prefix snapshot equals the JAX engine's
    generate(prefix=); debug=True (every segment's steps and the
    boundary flush as checked calls) gives the same tokens."""
    jeng, teng = _engines(debug=debug)
    pre = _toks(6, (40,))
    sfx = _toks(7, (2, 7))
    js = jeng.prefill_prefix(jnp.asarray(pre, jnp.int32))
    want = np.asarray(jeng.generate(jnp.asarray(sfx, jnp.int32), 45,
                                    prefix=js))
    snap = teng.prefill_prefix(torch.from_numpy(pre))
    got, _ = _collect(teng.generate_stream(torch.from_numpy(sfx), 45,
                                           segment=6, prefix=snap))
    np.testing.assert_array_equal(got, want)
