"""The port's `flash_extend_qhist` (CPU: its plain version) against the
JAX package's Pallas kernel in interpret mode, and the port's qhist
extend route (`core.attention._extend_attention_qhist`: the kernel's
flash state merged in torch with the window and self logits) against
the JAX package's extend attention.

Caches are built by the JAX package from seeded numpy inputs and copied
into the port's layout (uint32 words as int32), so both read the same
bits.

Tolerances:
  * plain version vs the Pallas kernel at compute_dtype=float32: rtol
    2e-5, atol 2e-4 (the same math in f32, summed in another order);
  * the route vs `extend_attention(impl="jnp")`: 1e-5;
  * the route vs `extend_attention(impl="pallas")` at W = 32, where the
    JAX package takes the qhist kernel by its own gate (bf16 compute):
    rtol = atol = 3e-2 (tests/test_flash_extend.py:51-52).

The JAX kernel visits whole 512-position chunks, so a row whose lower
bound leaves it nothing in a visited chunk carries junk (m = -1e30,
l > 0) that the merge multiplies by zero; the cases keep every row's
view of the history non-empty or empty for the whole chunk, where both
give the neutral (0, -1e30, 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.core.attention import extend_attention as j_extend
from kivi_tpu.kernels.flash_extend import flash_extend_qhist as j_qhist
from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import attention as TA
from kivi_tpu_torch.kernels.flash_extend import (NEG_INF, flash_extend_qhist,
                                                 flash_extend_qhist_plain)

torch.set_num_threads(2)

B, H, D, TMAX = 2, 2, 64, 1024
KTOL = dict(rtol=2e-5, atol=2e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def to_port(jc) -> KiviLayerCache:
    f = {n: _t(getattr(jc, n)) for n in (
        "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
        "k_win", "v_win")}
    return KiviLayerCache(**f, n_k_quant=int(jc.n_k_quant),
                          n_k_win=int(jc.n_k_win),
                          n_v_quant=int(jc.n_v_quant),
                          n_v_win=int(jc.n_v_win))


def _cfgs(bits, W, vf):
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=32,
              residual_length=W, v_flush=vf)
    return QuantConfig(**kw), JQuantConfig(**kw)


@functools.lru_cache(maxsize=None)
def _cache(jq, prompt, steps, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    cache = JC.init_layer_cache(B, H, D, TMAX, jq)
    if prompt:
        cache = JC.prefill_ingest(cache, n(B, H, prompt, D),
                                  n(B, H, prompt, D), jq)
    step = jax.jit(lambda c, k, v: JC.decode_append(c, k, v, jq))
    for _ in range(steps):
        cache = step(cache, n(B, H, 1, D), n(B, H, 1, D))
    return cache


# the window phases of tests/test_flash_extend.py:55-67, at W = 128
# (v_flush 32: n_v_quant trails n_k_quant) and at the slice's W = 32
PHASES = [(40, 0), (128, 0), (200, 60), (190, 140), (600, 30)]


def _qhist_both(jc, jq, tq, T1, r, seed, sliding_window=0, pad=None):
    qg = _np((B, H, r * T1, D), seed)
    kw = dict(group_size=32, k_bits=tq.k_bits, v_bits=tq.v_bits, t1=T1,
              sliding_window=sliding_window)
    want = j_qhist(jnp.asarray(qg), jc.k_codes, jc.k_scale, jc.k_mn,
                   jc.v_codes, jc.v_scale, jc.v_mn, jc.v_win, jc.n_k_quant,
                   jc.n_v_quant, jc.seq_len, compute_dtype=jnp.float32,
                   pad_len=None if pad is None else jnp.asarray(pad), **kw)
    tc = to_port(jc)
    args = (torch.from_numpy(qg), tc.k_codes, tc.k_scale, tc.k_mn,
            tc.v_codes, tc.v_scale, tc.v_mn, tc.v_win, tc.n_k_quant,
            tc.n_v_quant, tc.seq_len)
    got = flash_extend_qhist_plain(
        *args, pad_len=None if pad is None else torch.tensor(pad), **kw)
    return got, [np.asarray(w) for w in want], args, kw


def _assert_state(got, want):
    for g, w, what in zip(got, want, ("acc", "m", "l")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, err_msg=what, **KTOL)


@pytest.mark.parametrize("bits", [(2, 2), (4, 4), (2, 8)])
@pytest.mark.parametrize("W,vf", [(128, 32), (32, 32)])
@pytest.mark.parametrize("prompt,steps", PHASES)
def test_qhist_plain_matches_pallas(bits, W, vf, prompt, steps):
    tq, jq = _cfgs(bits, W, vf)
    jc = _cache(jq, prompt, steps, seed=prompt + steps)
    got, want, args, kw = _qhist_both(jc, jq, tq, T1=32, r=2, seed=1)
    _assert_state(got, want)
    if W == 128 and (prompt, steps) == (200, 60):
        assert int(jc.n_k_quant) > int(jc.n_v_quant)
    # on a CPU tensor the wrapper is the plain version
    for g, w in zip(flash_extend_qhist(*args, **kw), got):
        assert torch.equal(g, w)


def test_qhist_empty_history_is_neutral():
    tq, jq = _cfgs((2, 2), 32, 32)
    jc = _cache(jq, 20, 0, seed=3)
    assert int(jc.n_k_quant) == 0
    (acc, m, l), want, _, _ = _qhist_both(jc, jq, tq, T1=16, r=2, seed=2)
    _assert_state((acc, m, l), want)
    assert (acc == 0).all() and (m == NEG_INF).all() and (l == 0).all()


@pytest.mark.parametrize("W", [128, 32])
def test_qhist_left_pad(W):
    """Row 1's pad (520) lies past n_k_quant (512): the history is
    wholly masked there and the state is neutral."""
    tq, jq = _cfgs((2, 2), W, 32)
    jc = _cache(jq, 600, 0, seed=8)
    assert int(jc.n_k_quant) == (512 if W == 128 else 576)
    pad = np.array([37, 520 if W == 128 else 300], np.int32)
    got, want, _, _ = _qhist_both(jc, jq, tq, T1=64, r=2, seed=4, pad=pad)
    _assert_state(got, want)
    if W == 128:
        assert (got[1][1] == NEG_INF).all() and (got[2][1] == 0).all()


@pytest.mark.parametrize("window", [192, 512])
@pytest.mark.parametrize("pad", [None, (10, 300)])
def test_qhist_sliding_window(window, pad):
    """A per-row lower bound inside the folded query block: query i sees
    positions above seq_len + i - window."""
    tq, jq = _cfgs((2, 2), 128, 32)
    jc = _cache(jq, 600, 40, seed=9)
    T1 = 32
    # every row keeps some history in view (see the module docstring)
    assert int(jc.seq_len) + T1 - window < int(jc.n_k_quant)
    got, want, _, _ = _qhist_both(
        jc, jq, tq, T1=T1, r=2, seed=5, sliding_window=window,
        pad=None if pad is None else np.array(pad, np.int32))
    _assert_state(got, want)


# ---------------------------------------------------------------------------
# the qhist extend route
# ---------------------------------------------------------------------------

@pytest.fixture
def qhist_spy(monkeypatch):
    """Send every host-int extend call to the qhist route and count the
    kernel wrapper's calls."""
    monkeypatch.setattr(TA, "SPLIT_MIN_HISTORY", 0)
    calls = []
    fn = TA.flash_extend_qhist

    def wrapped(*a, **k):
        calls.append(a[8])              # n_k_quant
        return fn(*a, **k)

    monkeypatch.setattr(TA, "flash_extend_qhist", wrapped)
    return calls


def _route_inputs(jc, T1, r, seed):
    q = _np((B, H * r, T1, D), seed)
    k_new, v_new = _np((B, H, T1, D), seed + 1), _np((B, H, T1, D), seed + 2)
    return q, k_new, v_new


def _kw(masks):
    kw_j, kw_t = {}, {}
    if "pad" in masks:
        pad = np.array([0, 150], np.int32)
        kw_j["pad_len"], kw_t["pad_len"] = jnp.asarray(pad), torch.tensor(pad)
    if "swa" in masks:
        kw_j["sliding_window"] = kw_t["sliding_window"] = 100
    return kw_j, kw_t


@pytest.mark.parametrize("bits,W,vf", [((2, 2), 32, 32), ((4, 4), 128, 32),
                                       ((8, 8), 32, 32), ((2, 4), 128, 128)])
@pytest.mark.parametrize("prompt,steps", [(20, 0), (200, 60), (190, 140)])
@pytest.mark.parametrize("masks", ["none", "pad", "swa"])
def test_qhist_route_matches_jax_oracle(qhist_spy, bits, W, vf, prompt,
                                        steps, masks):
    tq, jq = _cfgs(bits, W, vf)
    jc = _cache(jq, prompt, steps, seed=prompt + steps)
    T1, r = 48, 2
    q, k_new, v_new = _route_inputs(jc, T1, r, seed=11)
    kw_j, kw_t = _kw(masks)
    want = j_extend(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                    jc, jq, impl="jnp", **kw_j)
    got = TA.extend_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                              torch.from_numpy(v_new), to_port(jc), tq,
                              **kw_t)
    assert qhist_spy == [int(jc.n_k_quant)]
    assert got.dtype == torch.float32 and got.shape == (B, H * r, T1, D)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", [(2, 2), (4, 4)])
@pytest.mark.parametrize("masks", ["none", "pad", "swa"])
def test_qhist_route_matches_jax_pallas_route(qhist_spy, bits, masks):
    """At W = 32 the JAX package's gate rejects its full extend kernel and
    takes qhist + a jnp merge (bf16 compute)."""
    tq, jq = _cfgs(bits, 32, 32)
    jc = _cache(jq, 600, 30, seed=12)
    q, k_new, v_new = _route_inputs(jc, 64, 2, seed=13)
    kw_j, kw_t = _kw(masks)
    want = j_extend(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                    jc, jq, impl="pallas", **kw_j)
    got = TA.extend_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                              torch.from_numpy(v_new), to_port(jc), tq,
                              **kw_t)
    assert qhist_spy == [int(jc.n_k_quant)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2,
                               atol=3e-2)


def test_qhist_route_fully_padded_first_chunk(qhist_spy):
    """An empty cache and a row padded past the chunk: only the causal
    diagonal is admitted, and the output stays finite."""
    tq, jq = _cfgs((2, 2), 32, 32)
    jc = _cache(jq, 0, 0, seed=0)
    q, k_new, v_new = _route_inputs(jc, 64, 2, seed=14)
    pad = np.array([3, 100], np.int32)
    want = j_extend(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                    jc, jq, impl="jnp", pad_len=jnp.asarray(pad))
    got = TA.extend_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                              torch.from_numpy(v_new), to_port(jc), tq,
                              pad_len=torch.tensor(pad))
    assert qhist_spy == [0]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
