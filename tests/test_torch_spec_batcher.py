"""The port's speculative batcher (kivi_tpu_torch.serving.spec_batcher,
CPU) against the JAX package's SpeculativeBatcher(impl="jnp"), mirroring
tests/test_spec_batcher.py: per-slot greedy tokens equal to the JAX
batcher's and to the port's own ContinuousBatcher's, with the same
iteration, acceptance and clamp counts, for a perfect, a mismatched and
an fp16 draft; EOS cut mid-block; on_token; the refusals; greedy slots
unchanged in sampled mode; the on-device accept-reject in torch (its
theorem, its one-hot prefix match); seeded sampling; and debug=True,
whose bodies keep every state tensor's storage across steps.

Both packages run the same f32 weights over f32 windows and scales (the
JAX batcher's bf16 caches are cast to f32 after construction), so the
greedy tokens are equal.  The fp16 draft's proposals may differ from
JAX's (its decode oracle rounds q and p to bf16, ROADMAP Queue 3), so
with it only the tokens are compared.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.serving.batcher import Request as JRequest
from kivi_tpu.serving.spec_batcher import SpeculativeBatcher as JSpecBatcher
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.spec_batcher import (SpeculativeBatcher,
                                                 spec_accept_device)

torch.set_num_threads(2)

MAX = 256
BUCKETS = (32, 64)
KW = dict(group_size=32, residual_length=32, scale_dtype="float32")


@pytest.fixture(autouse=True)
def _exact_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _bits(fp):
    return dict(k_bits=16, v_bits=16) if fp else dict(k_bits=2, v_bits=2)


@functools.lru_cache(maxsize=None)
def _params(small=False, seed=0):
    cfg = j_tiny_config(num_layers=1) if small else j_tiny_config()
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", torch.float32)


def _prompts(seed=0, lens=(20, 32, 45, 17)):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 256, size=n)] for n in lens]


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def _make(draft, k, slots, port=True, debug=False):
    small, seed, fp = draft
    dcfg = dict(num_layers=1) if small else {}
    if port:
        return SpeculativeBatcher(
            tiny_config(), QuantConfig(**KW, **_bits(False)), _params()[1],
            tiny_config(**dcfg), QuantConfig(**KW, **_bits(fp)),
            _params(small, seed)[1], num_slots=slots, max_seq_len=MAX, k=k,
            device="cpu", prompt_buckets=BUCKETS, cache_dtype=torch.float32,
            debug=debug)
    jb = JSpecBatcher(j_tiny_config(), JQuantConfig(**KW, **_bits(False)),
                      _params()[0], j_tiny_config(**dcfg),
                      JQuantConfig(**KW, **_bits(fp)),
                      _params(small, seed)[0], num_slots=slots,
                      max_seq_len=MAX, k=k, prompt_buckets=BUCKETS)
    jb.caches, jb.d_caches = _f32(jb.caches), _f32(jb.d_caches)
    return jb


@functools.lru_cache(maxsize=None)
def _jax_run(draft, k, slots, specs):
    jb = _make(draft, k, slots, port=False)
    res = jb.run([JRequest(uid=i, **dict(s)) for i, s in enumerate(specs)])
    return {u: r.tokens for u, r in res.items()}, dict(jb.stats)


@functools.lru_cache(maxsize=None)
def _base_run(slots, specs):
    tb = ContinuousBatcher(tiny_config(), QuantConfig(**KW, **_bits(False)),
                           _params()[1], num_slots=slots, max_seq_len=MAX,
                           device="cpu", prompt_buckets=BUCKETS,
                           cache_dtype=torch.float32)
    res = tb.run([Request(uid=i, **dict(s)) for i, s in enumerate(specs)])
    return {u: r.tokens for u, r in res.items()}


def _specs(prompts, new):
    return tuple(tuple(dict(prompt=tuple(p), max_new_tokens=new).items())
                 for p in prompts)


def _port_run(draft, k, slots, specs, debug=False):
    tb = _make(draft, k, slots, debug=debug)
    res = tb.run([Request(uid=i, **{**dict(s), "prompt": list(dict(s)[
        "prompt"])}) for i, s in enumerate(specs)])
    return {u: r.tokens for u, r in res.items()}, tb


PERFECT, MISMATCHED, FP_DRAFT = (False, 0, False), (True, 7, False), \
    (True, 5, True)


@pytest.mark.parametrize("draft,k,slots,pseed,lens,new", [
    (PERFECT, 4, 2, 0, (20, 32, 45, 17), 40),
    (MISMATCHED, 3, 2, 1, (20, 40), 25),
    (FP_DRAFT, 3, 2, 2, (24,), 30)])
def test_spec_batcher_matches_jax_and_base_batcher(draft, k, slots, pseed,
                                                   lens, new):
    """Per-uid greedy tokens equal to the JAX speculative batcher's and to
    the port's ContinuousBatcher's; with a KIVI draft the iteration,
    acceptance and clamp counts equal JAX's too.  The perfect draft
    (4 requests through 2 slots: churn, divergent phases, K and V
    flushes) accepts and clamps."""
    specs = _specs(_prompts(pseed, lens), new)
    got, tb = _port_run(draft, k, slots, specs)
    want, jstats = _jax_run(draft, k, slots, specs)
    assert got == want
    assert got == _base_run(slots, specs)
    if not draft[2]:
        assert {s: tb.stats[s] for s in jstats} == jstats
    if draft == PERFECT:
        assert tb.stats["clamped"] > 0 and tb.stats["accepted"] > 0
        assert tb.stats["accepted"] <= tb.stats["slot_steps"] * k


def test_eos_cuts_mid_block_and_retires():
    prompt = _prompts(seed=3, lens=(20,))[0]
    free = _base_run(1, _specs([prompt], 30))[0]
    eos = free[11]
    want = free[:free.index(eos) + 1]
    tb = _make(PERFECT, 4, 1)
    res = tb.run([Request(uid=0, prompt=prompt, max_new_tokens=30,
                          eos_token_id=eos)])
    assert res[0].tokens == want
    assert not tb.active.any()


def test_streaming_on_token():
    got = []
    prompt = _prompts(seed=4, lens=(20,))[0]
    tb = _make(PERFECT, 4, 1)
    tb.run([Request(uid=0, prompt=prompt, max_new_tokens=20,
                    on_token=got.append)])
    assert got == _base_run(1, _specs([prompt], 20))[0]


def test_rejects_penalty_prefix_and_oversized_requests():
    tb = _make(MISMATCHED, 4, 2)
    with pytest.raises(ValueError, match="repetition penalty"):
        tb.submit(Request(uid=1, prompt=[1, 2], max_new_tokens=4,
                          repetition_penalty=1.3))
    with pytest.raises(ValueError, match="prefixes"):
        tb.submit(Request(uid=2, prompt=[1, 2], max_new_tokens=4,
                          prefix_tokens=[3, 4]))
    with pytest.raises(ValueError, match="max_seq_len"):
        tb.submit(Request(uid=3, prompt=[1] * 40, max_new_tokens=MAX - 66))
    tb.submit(Request(uid=4, prompt=[1] * 40, max_new_tokens=MAX - 68))


def test_sampled_mode_greedy_slots_unchanged():
    """One sampled slot switches the step to the sampled bodies; the
    greedy slot's stream stays the oracle's (one-hot p and q reduce the
    on-device accept to the prefix match)."""
    prompts = _prompts(seed=6, lens=(20, 30))
    tb = _make(PERFECT, 3, 2)
    res = tb.run([Request(uid=0, prompt=prompts[0], max_new_tokens=25),
                  Request(uid=1, prompt=prompts[1], max_new_tokens=25,
                          temperature=0.8)])
    assert res[0].tokens == _base_run(1, _specs(prompts[:1], 25))[0]
    assert len(res[1].tokens) == 25 and max(res[1].tokens) < 256


def test_spec_accept_device_marginal_matches_target():
    """The Leviathan theorem for the torch accept-reject, batched over
    40,000 blocks at V = 6 with an adversarially spiky draft and draft
    tokens drawn from q: the first emitted token's marginal is p's
    (total variation < 0.02)."""
    rng = np.random.default_rng(0)
    V, k, n = 6, 2, 40_000
    p = torch.tensor(rng.dirichlet(np.ones(V), size=k + 1),
                     dtype=torch.float32)
    q = torch.tensor(rng.dirichlet(np.full(V, 0.3), size=k),
                     dtype=torch.float32)
    xs = torch.from_numpy(rng.choice(V, size=(n, k), p=q[0].double().numpy()
                                     / q[0].double().sum().item()))
    g = torch.Generator()
    g.manual_seed(1)
    emitted, j = spec_accept_device(p.expand(n, -1, -1), q.expand(n, -1, -1),
                                    xs, torch.full((n,), k), g)
    counts = np.bincount(emitted[:, 0].numpy(), minlength=V)
    tv = 0.5 * np.abs(counts / n - p[0].numpy()).sum()
    assert tv < 0.02, (tv, counts / n)
    assert ((j >= 0) & (j <= k)).all()


def test_spec_accept_device_greedy_onehot_is_prefix_match():
    """One-hot p and q (the greedy limit): accept is the prefix match, the
    correction or bonus the target's argmax; keff caps the accept."""
    V, k = 8, 3
    tgt = torch.tensor([[2, 5, 1, 4], [2, 5, 1, 4]])
    drf = torch.tensor([[2, 5, 7], [2, 5, 1]])
    p = torch.nn.functional.one_hot(tgt, V).float()
    q = torch.nn.functional.one_hot(drf, V).float()
    emitted, j = spec_accept_device(p, q, drf, torch.tensor([k, 1]))
    assert j.tolist() == [2, 1]
    assert emitted[0, :3].tolist() == [2, 5, 1]
    assert emitted[1, :2].tolist() == [2, 5]
    emitted, j = spec_accept_device(p[1:], q[1:], drf[1:],
                                    torch.tensor([k]))
    assert j.tolist() == [3] and emitted[0].tolist() == [2, 5, 1, 4]


def test_sampled_mode_seed_deterministic():
    prompt = _prompts(seed=9, lens=(20,))[0]
    outs = []
    for _ in range(2):
        tb = _make((True, 9, False), 3, 1)
        tb.gen.manual_seed(77)
        res = tb.run([Request(uid=0, prompt=prompt, max_new_tokens=15,
                              temperature=0.9, top_k=20)])
        outs.append(res[0].tokens)
    assert outs[0] == outs[1]
    assert len(outs[0]) == 15 and all(0 <= t < 256 for t in outs[0])


def _state_ptrs(tb) -> dict:
    """Every tensor the two step bodies read or write: the slot caches of
    both models (counters included), the per-slot controls and the step
    buffers."""
    out = {}
    for who, caches in (("t", tb.caches), ("d", tb.d_caches)):
        for i, c in enumerate(caches):
            out.update({(who, i, f.name): getattr(c, f.name).data_ptr()
                        for f in dataclasses.fields(c)})
    for name in ("cur_tok", "pos", "pad_dev", "act_dev", "temp_dev",
                 "topk_dev", "topp_dev", "n_dev", "keff_dev", "d_toks",
                 "q_probs", "res"):
        out[name] = getattr(tb, name).data_ptr()
    return out


def test_debug_bodies_keep_their_storage_and_match():
    """debug=True: every body a checked call and the watermark mirror
    checked against the device counters each step; the tokens equal the
    plain run's, and every state tensor keeps its storage from the first
    step to the last (a CUDA graph replays those addresses only), across
    admissions, retirements, flushes and sampled steps."""
    prompts = _prompts(seed=5, lens=(20, 45, 33))
    reqs = [dict(prompt=prompts[0], max_new_tokens=30),
            dict(prompt=prompts[1], max_new_tokens=20, temperature=0.7),
            dict(prompt=prompts[2], max_new_tokens=25)]
    runs = []
    for debug in (True, False):
        tb = _make(MISMATCHED, 3, 2, debug=debug)
        tb.gen.manual_seed(3)
        for i, r in enumerate(reqs):
            tb.submit(Request(uid=i, **r))
        tb.step()
        before = _state_ptrs(tb)
        steps = 1
        while tb.queue or tb.active.any():
            tb.step()
            steps += 1
            assert _state_ptrs(tb) == before, f"step {steps}"
        tb._retire()
        runs.append({u: r.tokens for u, r in tb.results.items()})
    assert runs[0] == runs[1]
    assert runs[0][0] == _base_run(1, _specs(prompts[:1], 30))[0]
