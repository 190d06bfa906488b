"""The port's continuous batcher (kivi_tpu_torch.serving.batcher, CPU)
against the JAX package's ContinuousBatcher(impl="jnp") on tiny_config,
mirroring tests/test_batcher.py (under its `_exact_matmul` precision).

Both run the same f32 weights over f32 windows and f32 scales (the JAX
batcher's slot caches are cast to f32 after construction; its admission
caches take their dtypes from them), so greedy tokens are equal on the
KIVI cache.  The fp16-cache path differs by design in one place: the
JAX oracle of fp decode rounds the query and the probabilities to bf16,
the port's does not (ROADMAP.md Queue 3), so a long greedy run can fork
at a near tie; `test_fp16_fork_is_a_near_tie` shows such a fork with
teacher-forced logits within the fp16 engine's 2e-2.
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
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import Engine

torch.set_num_threads(2)

CFG = tiny_config()
MAX = 256
BUCKETS = (32, 64)
FP16_TOL = 2e-2       # the fp16 engine's teacher-forced logits tolerance


@pytest.fixture(autouse=True)
def _exact_matmul():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                         torch.float32)
    return jp, tp


def _kw(bits):
    return dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=32,
                scale_dtype="float32")


def _batchers(bits, num_slots=2, **kw):
    jp, tp = _params()
    jb = JBatcher(j_tiny_config(), JQuantConfig(**_kw(bits)), jp,
                  num_slots=num_slots, max_seq_len=MAX, **kw)
    jb.caches = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jb.caches)
    tb = ContinuousBatcher(CFG, QuantConfig(**_kw(bits)), tp,
                           num_slots=num_slots, max_seq_len=MAX,
                           device="cpu", cache_dtype=torch.float32, **kw)
    return jb, tb


def _run_both(bits, specs, num_slots=2, **kw):
    """specs: list of Request kwargs.  Returns (jax results, port
    results) as {uid: tokens}."""
    jb, tb = _batchers(bits, num_slots, **kw)
    want = jb.run([JRequest(uid=i, **s) for i, s in enumerate(specs)])
    got = tb.run([Request(uid=i, **s) for i, s in enumerate(specs)])
    return ({u: r.tokens for u, r in want.items()},
            {u: r.tokens for u, r in got.items()})


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, CFG.vocab_size, size=n)]
            for n in sizes]


@pytest.mark.parametrize("bits,admission", [
    (2, "bucketed"), (2, "chunked"), (4, "chunked"), (8, "bucketed"),
    (16, "bucketed"), (16, "chunked")])
def test_batcher_matches_jax(bits, admission):
    """Greedy requests through 2 slots (admissions and retirements
    interleave): tokens equal per uid.  The KIVI runs decode past K and
    V flushes at divergent per-slot phases; the fp16 runs stay short
    (see the module docstring)."""
    kw = ({"prefill_chunk": 16} if admission == "chunked"
          else {"prompt_buckets": BUCKETS})
    new = 6 if bits == 16 else 30
    prompts = _prompts(bits, (20, 32, 45, 17))
    specs = [dict(prompt=p, max_new_tokens=new + i)
             for i, p in enumerate(prompts)]
    want, got = _run_both(bits, specs, **kw)
    assert sorted(got) == [0, 1, 2, 3]
    assert got == want
    assert all(len(got[i]) == new + i for i in range(4))


def test_batcher_eos_rejection_and_penalty_match_jax():
    """EOS retires a slot (the first run's 3rd token as EOS); an
    oversized and an empty prompt are rejected with empty results; the
    per-request repetition penalty is applied from the first token."""
    p = _prompts(9, (28, 16, 30))
    want, got = _run_both(2, [dict(prompt=p[1], max_new_tokens=8)],
                          num_slots=1, prompt_buckets=BUCKETS)
    assert got == want
    eos = got[0][2]
    specs = [dict(prompt=p[1], max_new_tokens=8, eos_token_id=eos),
             dict(prompt=[1] * 60, max_new_tokens=MAX),      # too long
             dict(prompt=[], max_new_tokens=4),              # empty
             dict(prompt=p[0], max_new_tokens=8, repetition_penalty=1.8),
             dict(prompt=p[2], max_new_tokens=8, repetition_penalty=0.7)]
    want, got = _run_both(2, specs, prompt_buckets=BUCKETS)
    assert got == want
    assert got[0] == want[0][:3] and got[0][-1] == eos
    assert got[1] == [] and got[2] == []
    assert len(got[3]) == len(got[4]) == 8


def test_batcher_mixed_sampling():
    """Greedy and sampled requests share the decode step: greedy ones
    equal the JAX batcher's, top_k = 1 at a temperature is greedy too,
    and sampled tokens are valid and reproducible from the seed."""
    p = _prompts(7, (24, 30))
    specs = [dict(prompt=p[0], max_new_tokens=6),
             dict(prompt=p[1], max_new_tokens=6, temperature=1.5, top_k=1),
             dict(prompt=p[0], max_new_tokens=6, temperature=2.0,
                  top_p=0.95)]
    want, got = _run_both(2, specs, prompt_buckets=BUCKETS)
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[2]) == 6
    assert all(0 <= t < CFG.vocab_size for t in got[2])
    _, tb = _batchers(2, prompt_buckets=BUCKETS)
    again = tb.run([Request(uid=i, **s) for i, s in enumerate(specs)])
    assert again[2].tokens == got[2]


def test_cancel_queued_and_active():
    """cancel() drops a queued request and frees a mid-decode slot
    (partial tokens recorded); the freed slot serves new traffic."""
    _, tb = _batchers(2, num_slots=1, prompt_buckets=(32,))
    p = _prompts(0, (10, 10, 10))
    tb.submit(Request(uid=0, prompt=p[0], max_new_tokens=50))
    tb.submit(Request(uid=1, prompt=p[1], max_new_tokens=6))   # queued
    tb.step()
    tb.step()
    assert tb.active[0] and len(tb.slot_out[0]) >= 2
    assert tb.cancel(1) and tb.results[1].tokens == []
    n_partial = len(tb.slot_out[0])
    assert tb.cancel(0)
    assert not tb.active.any() and not tb.act_dev.any()
    assert len(tb.results[0].tokens) == n_partial
    assert not tb.cancel(99)
    res = tb.run([Request(uid=2, prompt=p[2], max_new_tokens=4)])
    assert len(res[2].tokens) == 4


def test_streaming_and_unported_prefix():
    """on_token streams each token as it is harvested; the prefix paths
    are served: prefix_tokens without a prefix cache is refused with the
    JAX batcher's ValueError, and a batcher-wide prefix streams through
    on_token too."""
    _, tb = _batchers(2, prompt_buckets=BUCKETS)
    seen = []
    p = _prompts(1, (12,))[0]
    res = tb.run([Request(uid=0, prompt=p, max_new_tokens=5,
                          on_token=seen.append)])
    assert seen == res[0].tokens and len(seen) == 5
    with pytest.raises(ValueError, match="prefix_cache"):
        tb.submit(Request(uid=1, prompt=p, max_new_tokens=2,
                          prefix_tokens=[1, 2]))
    _, tp = _params()
    eng = Engine(CFG, QuantConfig(**_kw(2)), tp, max_seq_len=MAX,
                 batch_size=1, device="cpu", cache_dtype=torch.float32)
    snap = eng.prefill_prefix(_prompts(2, (40,))[0])
    pb = ContinuousBatcher(CFG, QuantConfig(**_kw(2)), tp, 1, MAX,
                           device="cpu", prefix=snap,
                           cache_dtype=torch.float32)
    seen = []
    res = pb.run([Request(uid=2, prompt=p, max_new_tokens=5,
                          on_token=seen.append)])
    assert seen == res[2].tokens and len(seen) == 5
    assert pb.fill[0] == 40 + 12 + 4


def test_fp16_fork_is_a_near_tie():
    """Long greedy fp16 runs: each uid's tokens equal the JAX batcher's
    up to a first fork, if any.  At a fork, both streams are replayed
    teacher-forced (the JAX tokens) through the port's and the JAX
    package's batch-1 engines on the same left-padded prompt: logits
    agree within 2e-2 at every step, and the two forked tokens' logits
    lie within 2 x 2e-2 of each other — a near tie that the JAX
    oracle's bf16 rounding tips."""
    prompts = _prompts(0, (20, 32, 45, 17, 60))
    specs = [dict(prompt=p, max_new_tokens=30 + i)
             for i, p in enumerate(prompts)]
    want, got = _run_both(16, specs, prompt_buckets=BUCKETS)
    jp, tp = _params()
    kw = _kw(16)
    for uid, p in enumerate(prompts):
        diff = [i for i, (a, b) in enumerate(zip(got[uid], want[uid]))
                if a != b]
        if not diff:
            assert got[uid] == want[uid]
            continue
        fork = diff[0]
        assert fork > 0, "first tokens differ"
        bucket = 32 if len(p) <= 32 else 64
        pad = bucket - len(p)
        toks = np.array([[0] * pad + p])
        jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**kw),
                       params=jp, max_seq_len=MAX, batch_size=1, impl="jnp")
        jeng.cache_dtype = jnp.float32
        teng = Engine(cfg=CFG, qcfg=QuantConfig(**kw), params=tp,
                      max_seq_len=MAX, batch_size=1, device="cpu",
                      cache_dtype=torch.float32)
        jpad = jnp.asarray([pad], jnp.int32)
        _, jc = jeng._prefill(jeng.params, jnp.asarray(toks, jnp.int32),
                              jeng.init_caches(), jpad)
        _, tc = teng._prefill(torch.from_numpy(toks), pad_lens=[pad])
        for j in range(fork):
            tok = np.array([[want[uid][j]]])
            pos = np.array([[len(p) + j]])
            jl, jc = jeng._decode(jeng.params, jnp.asarray(tok, jnp.int32),
                                  jnp.asarray(pos, jnp.int32), jc, jpad)
            tl, tc = teng.decode_step(torch.from_numpy(tok),
                                      torch.from_numpy(pos), tc,
                                      pad_lens=[pad])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=FP16_TOL, rtol=0,
                                       err_msg=f"uid {uid} step {j}")
        a, b = want[uid][fork], got[uid][fork]
        assert abs(float(tl[0, a]) - float(tl[0, b])) <= 2 * FP16_TOL
