"""The port's speculative engine (kivi_tpu_torch.serving.speculative, CPU)
against the JAX package's SpeculativeEngine (impl="jnp"), mirroring
tests/test_speculative.py: a perfect draft (the target itself) across
flush boundaries, a mismatched 1-layer draft, k over a range, an fp16
draft cache, EOS, the stream, generate_device, the capacity refusals,
the accept-reject theorem and seeded sampling.

Both packages run the same f32 weights (params_from_jax) over f32
windows and f32 scales, so the greedy tokens, the acceptance counts,
the clamped depths and the flush statistics are equal, and the tokens
equal the port's own Engine's greedy ones.  The fp16 draft's proposals
may differ from the JAX draft's (its decode oracle rounds q and p to
bf16, ROADMAP Queue 3), so with it only the tokens are compared.  The
JAX references run once per module (cached).
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
from kivi_tpu.serving.speculative import SpeculativeEngine as JSpec
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving import speculative as TS
from kivi_tpu_torch.serving.engine import Engine
from kivi_tpu_torch.serving.speculative import SpeculativeEngine

torch.set_num_threads(2)

MAX = 512
KW = dict(group_size=32, residual_length=32, scale_dtype="float32")


@functools.lru_cache(maxsize=None)
def _params(small=False, seed=0):
    cfg = j_tiny_config(num_layers=1) if small else j_tiny_config()
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", torch.float32)


def _bits(fp):
    return dict(k_bits=16, v_bits=16) if fp else dict(k_bits=2, v_bits=2)


@functools.lru_cache(maxsize=None)
def _jeng(small=False, seed=0, fp=False):
    cfg = j_tiny_config(num_layers=1) if small else j_tiny_config()
    e = JEngine(cfg=cfg, qcfg=JQuantConfig(**KW, **_bits(fp)),
                params=_params(small, seed)[0], max_seq_len=MAX,
                batch_size=1)
    e.cache_dtype = jnp.float32
    return e


@functools.lru_cache(maxsize=None)
def _teng(small=False, seed=0, fp=False, debug=False):
    cfg = tiny_config(num_layers=1) if small else tiny_config()
    return Engine(cfg, QuantConfig(**KW, **_bits(fp)),
                  _params(small, seed)[1], MAX, 1, device="cpu",
                  cache_dtype=torch.float32, debug=debug)


@functools.lru_cache(maxsize=None)
def _jspec(small=False, seed=0, fp=False, k=4):
    return JSpec(_jeng(), _jeng(small, seed, fp), k=k)


@functools.lru_cache(maxsize=None)
def _tspec(small=False, seed=0, fp=False, k=4, debug=False):
    return SpeculativeEngine(_teng(debug=debug),
                             _teng(small, seed, fp, debug), k=k)


def _prompt(seed, n=20):
    return np.random.default_rng(seed).integers(1, 256, (1, n)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(draft, k, pseed, n, new, eos=None):
    """The JAX speculative engine's (tokens, last_acceptance, last_keff,
    stats) for one configuration; stats are this run's alone."""
    spec = _jspec(*draft, k=k)
    before = dict(spec.stats)
    toks = np.asarray(spec.generate(jnp.asarray(_prompt(pseed, n)), new,
                                    eos_token_id=eos))
    stats = {s: spec.stats[s] - before[s] for s in spec.stats}
    return toks, list(spec.last_acceptance), list(spec.last_keff), stats


def _port_run(draft, k, pseed, n, new, eos=None, debug=False):
    spec = _tspec(*draft, k=k, debug=debug)
    before = dict(spec.stats)
    toks = spec.generate(torch.from_numpy(_prompt(pseed, n)), new,
                         eos_token_id=eos)
    stats = {s: spec.stats[s] - before[s] for s in spec.stats}
    return toks, list(spec.last_acceptance), list(spec.last_keff), stats


@functools.lru_cache(maxsize=None)
def _engine_greedy(pseed, n, new):
    return _teng().generate(torch.from_numpy(_prompt(pseed, n)),
                            new).numpy()


PERFECT, MISMATCHED = (False, 0, False), (True, 7, False)


def _assert_same_as_jax(draft, k, pseed, n, new, debug=False):
    got = _port_run(draft, k, pseed, n, new, debug=debug)
    want = _jax_run(draft, k, pseed, n, new)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], _engine_greedy(pseed, n, new))
    return got


def test_perfect_draft_exact_across_boundaries():
    """Draft == target at k = 5 over 60 tokens: tokens, acceptance, keff
    and flush statistics equal to JAX's; every block accepted up to its
    clamp, and clamps and boundary flushes fire."""
    toks, acc, keff, stats = _assert_same_as_jax(PERFECT, 5, 2, 25, 60)
    assert all(j == ke for j, ke in zip(acc, keff))
    assert max(acc) == 5
    assert stats["clamped"] > 0 and stats["boundary_flush_k"] > 0


def test_mismatched_draft_still_exact():
    _assert_same_as_jax(MISMATCHED, 4, 1, 20, 19)


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_exact_across_flush_boundaries(k):
    """A 1-layer draft (seed 3): partial acceptance, 60 tokens across K
    and V flushes at several phases."""
    toks, acc, keff, stats = _assert_same_as_jax((True, 3, False), k, 2, 25,
                                                 60)
    assert stats["boundary_flush_k"] > 0 and stats["boundary_flush_v"] > 0


def test_fp16_draft_cache():
    """An fp16 draft cache (its rollback is the length alone): the
    tokens equal JAX's and the engine's."""
    got = _port_run((True, 5, False), 3, 3, 20, 33)[0]
    fp = _port_run((True, 5, True), 3, 3, 20, 33)[0]
    np.testing.assert_array_equal(fp, _jax_run((True, 5, True), 3, 3, 20,
                                               33)[0])
    np.testing.assert_array_equal(fp, got)


def test_eos_early_exit():
    free = _engine_greedy(4, 20, 24)
    eos = int(free[0, 6])
    want = free[:, :np.argmax(free[0] == eos) + 1]
    got = _port_run(PERFECT, 4, 4, 20, 24, eos=eos)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_run(PERFECT, 4, 4, 20, 24,
                                                eos=eos)[0])


def test_generate_stream_matches_generate():
    """Blocks concatenate to generate()'s output; the first is the first
    token alone; EOS cuts mid-block."""
    spec = _tspec(True, 3, False, k=4)
    toks = torch.from_numpy(_prompt(8))
    want = spec.generate(toks, 21)
    blocks = list(spec.generate_stream(toks, 21))
    assert blocks[0].shape == (1,)
    np.testing.assert_array_equal(np.concatenate(blocks), want[0])
    eos = int(want[0, 7])
    np.testing.assert_array_equal(
        np.concatenate(list(spec.generate_stream(toks, 21,
                                                 eos_token_id=eos))),
        spec.generate(toks, 21, eos_token_id=eos)[0])


@pytest.mark.parametrize("draft,k,pseed,n,new", [
    (PERFECT, 5, 2, 25, 40), (MISMATCHED, 4, 1, 20, 30),
    ((True, 5, True), 3, 3, 20, 22)])
def test_generate_device_matches_host_loop(draft, k, pseed, n, new):
    """One iteration a step (masked flushes, k+1 draft steps, verify,
    greedy accept, rollback, the output at the device count): the host
    loop's tokens, for perfect, mismatched and fp16 drafts."""
    spec = _tspec(*draft, k=k)
    toks = torch.from_numpy(_prompt(pseed, n))
    np.testing.assert_array_equal(spec.generate_device(toks, new),
                                  spec.generate(toks, new))


def test_generate_device_eos():
    spec = _tspec(*MISMATCHED, k=4)
    toks = torch.from_numpy(_prompt(4))
    free = spec.generate(toks, 24)
    eos = int(free[0, 6])
    np.testing.assert_array_equal(spec.generate_device(toks, 24,
                                                       eos_token_id=eos),
                                  spec.generate(toks, 24, eos_token_id=eos))


def test_debug_runs_checked_bodies_and_match():
    """debug=True: every step a checked call and the watermark mirror
    checked against the device counters after each boundary flush; the
    tokens, acceptance and keff are the plain run's."""
    got = _port_run(PERFECT, 5, 2, 25, 60, debug=True)
    want = _port_run(PERFECT, 5, 2, 25, 60)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]


def test_state_keeps_its_storage_across_calls():
    """The bodies a CUDA graph captures write their state in place: every
    tensor of the step state and of both caches keeps its storage across
    generate calls and generate_device (a replay reads those addresses
    only), and the counters return to host ints after each call."""
    import dataclasses
    spec = SpeculativeEngine(_teng(), _teng(True, 3), k=3)
    toks = torch.from_numpy(_prompt(5))
    spec.generate(toks, 12)

    def ptrs():
        st = spec._st
        out = {f.name: getattr(st, f.name).data_ptr()
               for f in dataclasses.fields(st)
               if isinstance(getattr(st, f.name), torch.Tensor)}
        for i, c in enumerate(spec._t_caches + spec._d_caches):
            out.update({(i, f.name): getattr(c, f.name).data_ptr()
                        for f in dataclasses.fields(c)
                        if isinstance(getattr(c, f.name), torch.Tensor)})
        return out

    before = ptrs()
    spec.generate(toks, 20)
    spec.generate(toks, 9, temperature=0.7, top_k=5)
    assert ptrs() == before
    assert all(isinstance(c.n_k_quant, int) for c in spec._t_caches)
    spec.generate_device(toks, 15)
    device = ptrs()
    assert {k: device[k] for k in before} == before
    spec.generate_device(toks, 15)
    assert ptrs() == device


def test_capacity_and_construction_refusals():
    spec = _tspec(*MISMATCHED, k=4)
    with pytest.raises(ValueError, match="exceeds"):
        spec.generate(torch.ones(1, 500, dtype=torch.long), 9)
    with pytest.raises(ValueError, match="exceeds"):
        spec.generate_device(torch.ones(1, 500, dtype=torch.long), 9)
    big = Engine(tiny_config(), QuantConfig(**KW, k_bits=2, v_bits=2),
                 _params()[1], 128, 2, device="cpu")
    with pytest.raises(ValueError, match="batch_size=1"):
        SpeculativeEngine(big, _teng())
    with pytest.raises(ValueError, match="batch_size=1"):
        SpeculativeEngine(_teng(), big)
    other = Engine(tiny_config(vocab_size=128),
                   QuantConfig(**KW, k_bits=2, v_bits=2),
                   _params()[1], 128, 1, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeEngine(_teng(), other)


def test_spec_accept_marginal_matches_target():
    """The Leviathan theorem for the port's spec_accept: the first emitted
    token's marginal is the target's p, for an adversarially spiky q
    (V = 6, 40,000 draws; total variation < 0.02)."""
    rng = np.random.default_rng(0)
    V = 6
    p = rng.dirichlet(np.ones(V), size=2)
    q = rng.dirichlet(np.full(V, 0.3), size=1)
    n = 40_000
    counts = np.zeros(V)
    xs = rng.choice(V, size=n, p=q[0])
    us = rng.random(n)
    for t in range(n):
        counts[TS.spec_accept(p, q, np.asarray([xs[t]]),
                              np.asarray([us[t]]), rng)[0]] += 1
    tv = 0.5 * np.abs(counts / n - p[0]).sum()
    assert tv < 0.02, (tv, counts / n, p[0])


def test_spec_accept_is_the_jax_function():
    """The same draws give the same emitted tokens as the JAX package's
    spec_accept (a rejection, a full accept with the bonus)."""
    from kivi_tpu.serving.speculative import spec_accept as j_accept
    rng = np.random.default_rng(3)
    V, k = 7, 3
    p = rng.dirichlet(np.ones(V), size=k + 1)
    q = rng.dirichlet(np.ones(V), size=k)
    for trial in range(50):
        xs = rng.integers(0, V, k)
        us = rng.random(k)
        a = TS.spec_accept(p, q, xs, us, np.random.default_rng(trial))
        b = j_accept(p, q, xs, us, np.random.default_rng(trial))
        assert a == b


def test_sampled_generation_is_seed_deterministic():
    """temperature > 0 end to end: in vocabulary, and one generator seed
    reproduces the stream (the device draws and the host accept both
    keyed off it)."""
    spec = _tspec(True, 3, False, k=4)
    kw = dict(temperature=0.8, top_k=20, top_p=0.95)
    outs = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(11)
        outs.append(spec.generate(torch.from_numpy(_prompt(6)), 25,
                                  generator=g, **kw))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (1, 25) and (outs[0] < 256).all()
