"""The port's multi-prefix store (kivi_tpu_torch.serving.prefix_cache) and
the batcher's prefix admission (CPU), mirroring tests/test_prefix_manager.py
and tests/test_batcher.py:219-340.

Exact hits return the stored snapshot, extend hits grow the longest
stored prefix through Engine.extend, the LRU respects its byte budget;
a batcher request behind a prefix (batcher-wide or Request.prefix_tokens)
is token-equal to the JAX batcher's (f32 caches, as
tests/test_torch_batcher.py) and, where the admission's chunk-and-tail
split is exact (the fp16 cache, or a prompt shorter than a chunk), to the
batch-1 engine's generate(prefix=).  Tolerance: tokens equal.
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
from kivi_tpu.serving.batcher import ContinuousBatcher as JBatcher
from kivi_tpu.serving.batcher import Request as JRequest
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu.serving.prefix_cache import snapshot_bytes as j_snapshot_bytes
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import Engine
from kivi_tpu_torch.serving.prefix_cache import PrefixCache, snapshot_bytes

torch.set_num_threads(2)

CFG = tiny_config()
MAX = 256


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


def _kw(bits):
    return dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=32,
                scale_dtype="float32")


def _eng(bits=8, batch=1):
    return Engine(cfg=CFG, qcfg=QuantConfig(**_kw(bits)), params=_params()[1],
                  max_seq_len=MAX, batch_size=batch, device="cpu",
                  cache_dtype=torch.float32)


def _batcher(bits, **kw):
    return ContinuousBatcher(CFG, QuantConfig(**_kw(bits)), _params()[1],
                             num_slots=2, max_seq_len=MAX, device="cpu",
                             cache_dtype=torch.float32, **kw)


def _ids(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 256, n)]


# ---------------------------------------------------------------------------
# the store (tests/test_prefix_manager.py)
# ---------------------------------------------------------------------------

def test_exact_hit_returns_stored_snapshot():
    pc = PrefixCache(_eng())
    a = _ids(0, 40)
    s1 = pc.get(a)
    s2 = pc.get(torch.tensor(a))
    assert s1 is s2 and pc.misses == 1 and pc.hits == 1
    assert s1.length == 40 and len(pc) == 1
    with pytest.raises(ValueError, match="empty prefix"):
        pc.get([])


def test_longest_prefix_extend():
    eng = _eng()
    pc = PrefixCache(eng)
    a = _ids(1, 32)
    pc.get(a)                        # miss
    pc.get(a[:16] + _ids(2, 8))      # shares 16 tokens only: a miss
    s = pc.get(a + _ids(3, 16))      # extends the 32-token snapshot
    assert pc.misses == 2 and pc.extends == 1 and len(pc) == 3
    assert s.length == 48
    base, n = pc.lookup(a)
    assert n == 32
    want = eng.extend(base, s.tokens[0, 32:])
    assert torch.equal(s.tokens, want.tokens)
    for x, y in zip(s.caches, want.caches):
        assert torch.equal(x.k_codes, y.k_codes)


def test_lru_eviction_under_byte_budget():
    eng = _eng()
    one = snapshot_bytes(PrefixCache(eng).get(_ids(10, 32)))
    pc = PrefixCache(eng, max_bytes=int(2.5 * one))
    keys = [_ids(11, 32), _ids(12, 32), _ids(13, 32)]
    pc.get(keys[0])
    pc.get(keys[1])
    pc.get(keys[0])          # keys[1] becomes the least recently used
    pc.get(keys[2])          # the budget forces one eviction
    assert pc.evictions == 1 and len(pc) == 2
    assert pc.lookup(keys[1])[0] is None
    assert pc.lookup(keys[0])[0] is not None
    assert pc.nbytes <= pc.max_bytes


def test_oversized_snapshot_not_stored_and_put():
    eng = _eng()
    one = snapshot_bytes(PrefixCache(eng).get(_ids(14, 32)))
    pc = PrefixCache(eng, max_bytes=one // 2)
    s = pc.get(_ids(15, 32))
    assert s.length == 32 and len(pc) == 0
    big = PrefixCache(eng)
    big.put(s)
    assert big.lookup(_ids(15, 32) + [7])[1] == 32


@pytest.mark.parametrize("bits", [2, 16])
def test_snapshot_bytes_match_jax(bits):
    """snapshot_bytes counts every tensor's bytes, as the JAX function
    counts leaves: the same bytes for the same cache layout; KIVI-2 is
    several times smaller than fp16 at one cache length."""
    jp, _ = _params()
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**_kw(bits)),
                   params=jp, max_seq_len=MAX, batch_size=1)
    jeng.cache_dtype = jnp.float32
    ids = _ids(16, 40)
    jsnap = jeng.prefill_prefix(jnp.asarray(ids, jnp.int32))
    snap = _eng(bits).prefill_prefix(ids)
    # the port keeps token ids as int64 (the JAX package int32) and its
    # counters as host ints (the JAX package's are 0-d int32 arrays)
    counters = sum(x.nbytes for x in jax.tree_util.tree_leaves(jsnap.caches)
                   if x.ndim == 0)
    assert counters == 4 * len(snap.caches) * (4 if bits == 2 else 1)
    assert snapshot_bytes(snap) == \
        j_snapshot_bytes(jsnap) - counters + 4 * len(ids)
    if bits == 2:
        assert snapshot_bytes(_eng(16).prefill_prefix(ids)) > \
            3 * snapshot_bytes(snap)


# ---------------------------------------------------------------------------
# prefix admission (tests/test_batcher.py:219-340, test_prefix_manager.py)
# ---------------------------------------------------------------------------

def test_batcher_per_request_prefix_matches_engine():
    """Request.prefix_tokens through the store: the second request reuses
    the snapshot, and the first's tokens equal the batch-1 engine's
    generate(prefix=) (prompts shorter than a chunk: the tail alone)."""
    eng = _eng()
    pc = PrefixCache(eng)
    pfx, prompt = _ids(20, 40), _ids(21, 12)
    bat = _batcher(8, prefix_cache=pc)
    res = bat.run([Request(uid=0, prompt=prompt, max_new_tokens=8,
                           prefix_tokens=pfx),
                   Request(uid=1, prompt=_ids(22, 9), max_new_tokens=8,
                           prefix_tokens=pfx)])
    assert pc.misses == 1 and pc.hits == 1
    want = _eng().generate(torch.tensor([prompt]), 8, prefix=pc.get(pfx))
    assert res[0].tokens == want[0].tolist()


def test_submit_prefix_without_cache_raises():
    bat = _batcher(8)
    with pytest.raises(ValueError, match="prefix_cache"):
        bat.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=2,
                           prefix_tokens=[3, 4]))
    bat.submit(Request(uid=1, prompt=[1, 2], max_new_tokens=2,
                       prefix_tokens=[]))           # empty: no prefix
    assert bat.queue[-1].prefix_tokens is None


def test_batcher_shared_prefix_matches_engine_fp16():
    """A batcher-wide prefix over the fp16 cache: each request equals the
    batch-1 engine's generate(prefix=) on its prompt (the chunk-and-tail
    admission is exact there).  Prompts: the tail alone (7 < chunk),
    chunk + tail (20 = 16 + 4), whole chunks (32)."""
    eng = _eng(16)
    snap = eng.prefill_prefix(_ids(23, 40))
    prompts = [_ids(24 + i, n) for i, n in enumerate((7, 20, 32))]
    bat = _batcher(16, prefill_chunk=16, prefix=snap)
    res = bat.run([Request(uid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        want = eng.generate(torch.tensor([p]), 6, prefix=snap)
        assert res[i].tokens == want[0].tolist(), i


def _jax_batcher(bits, jsnap, **kw):
    jb = JBatcher(j_tiny_config(), JQuantConfig(**_kw(bits)), _params()[0],
                  num_slots=2, max_seq_len=MAX, prefix=jsnap, **kw)
    jb.caches = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jb.caches)
    return jb


@pytest.mark.parametrize("bits,chunk", [(2, 32), (4, 0)])
def test_batcher_shared_prefix_matches_jax(bits, chunk):
    """2-bit with chunks of 32 and 4-bit tail-only admission: greedy and
    penalized requests behind a prefix equal the JAX batcher's, prompts
    crossing chunks, tails and window boundaries; one that cannot fit
    prefix + prompt + max_new is rejected with an empty result."""
    jp, tp = _params()
    pfx = _ids(30, 64)
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**_kw(bits)),
                   params=jp, max_seq_len=MAX, batch_size=1)
    jeng.cache_dtype = jnp.float32
    jsnap = jeng.prefill_prefix(jnp.asarray(pfx, jnp.int32))
    snap = _eng(bits).prefill_prefix(pfx)
    prompts = [_ids(31, 40), _ids(32, 7), _ids(33, MAX - 64),
               _ids(34, 70)]
    specs = [dict(prompt=prompts[0], max_new_tokens=8,
                  repetition_penalty=1.5),
             dict(prompt=prompts[1], max_new_tokens=12),
             dict(prompt=prompts[2], max_new_tokens=8),
             dict(prompt=prompts[3], max_new_tokens=10)]
    want = _jax_batcher(bits, jsnap, prefill_chunk=chunk).run(
        [JRequest(uid=i, **s) for i, s in enumerate(specs)])
    bat = _batcher(bits, prefill_chunk=chunk, prefix=snap)
    got = bat.run([Request(uid=i, **s) for i, s in enumerate(specs)])
    assert got[2].tokens == [] == want[2].tokens          # rejected
    for i in (0, 1, 3):
        assert got[i].tokens == [int(t) for t in want[i].tokens], i


def test_prefix_admission_at_window_boundary_matches_jax():
    """prefix + prompt a multiple of W (tests/test_batcher.py:302-326):
    the tail ends on a full window (the JAX tail's masked steps run on
    past it, where a write that is not masked would land on the last
    real token; the port's tail stops at the prompt's end)."""
    jp, _ = _params()
    pfx = _ids(40, 40)
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**_kw(2)),
                   params=jp, max_seq_len=MAX, batch_size=1)
    jeng.cache_dtype = jnp.float32
    jsnap = jeng.prefill_prefix(jnp.asarray(pfx, jnp.int32))
    snap = _eng(2).prefill_prefix(pfx)
    for n in (24, 23):          # 40 + 24 = 2W (the boundary), 63 (control)
        prompt = _ids(41 + n, n)
        want = _jax_batcher(2, jsnap).run(
            [JRequest(uid=0, prompt=prompt, max_new_tokens=10)])[0].tokens
        got = _batcher(2, prefix=snap).run(
            [Request(uid=0, prompt=prompt, max_new_tokens=10)])[0].tokens
        assert got == [int(t) for t in want], n


def test_prefix_batcher_debug_and_storage():
    """debug=True (every admission forward, tail step and decode step a
    checked call) gives the same tokens; the tail step keeps its state's
    storage and reads the batch-1 cache's device counters."""
    pc_snap = _eng(2).prefill_prefix(_ids(50, 33))
    prompts = [_ids(51, 45), _ids(52, 10)]
    outs = []
    for debug in (False, True):
        bat = _batcher(2, prefill_chunk=32, prefix=pc_snap, debug=debug)
        ptrs = [bat._tail_tok.data_ptr(), bat._tail_logits.data_ptr()]
        outs.append(bat.run([Request(uid=i, prompt=p, max_new_tokens=7,
                                     temperature=0.7 * i)
                             for i, p in enumerate(prompts)]))
        assert [bat._tail_tok.data_ptr(), bat._tail_logits.data_ptr()] == ptrs
        assert isinstance(bat._one[0].n_k_quant, int)   # back to host ints
    for i in range(2):
        assert outs[0][i].tokens == outs[1][i].tokens
