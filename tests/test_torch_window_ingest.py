"""The window-only ingest of the speculative decoders in the port
(kivi_tpu_torch.cache.kivi_cache.window_append_capped /
rollback_counters, fp_cache.rollback, models.modeling.forward(
ingest="window"); CPU) against the JAX package's
(kivi_tpu/cache/kivi_cache.py:404-455, kivi_tpu/models/modeling.py:
112-130, 202-245):

  * the capped append and the rollback with host-int counters, and with
    per-row device counters (rows at different window fills, one
    inactive) against jax.vmap over batch-1 caches, appends that
    overflow a window included: the window's last row is never
    overwritten by a token that does not fit;
  * forward(ingest="window") in extend (every position's logits) and
    decode modes, over the KIVI and the fp cache, host-int and per-row
    (vmapped JAX forward over slots with `active=`).

Tolerance: cache fields and counters equal for the cache functions
(they move bytes, no arithmetic); logits atol 1e-4 and windows atol
1e-5 in f32 for the forward (the projections sum in another order),
but fp16-cache decode logits atol 2e-2: the JAX fp-decode oracle rounds
q and p to bf16 and the port does not (ROADMAP Queue 3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import fp_cache as JF
from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu_torch.cache import fp_cache as TF
from kivi_tpu_torch.cache import kivi_cache as TC
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models import modeling as TM
from kivi_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

FIELDS = ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
          "k_win", "v_win")
COUNTERS = ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win")
H, D, TMAX, W = 2, 32, 256, 32
FWD_TMAX = 128            # the forward tests' caches (every fill fits)
FP_DECODE_ATOL = 2e-2     # see the module docstring
KW = dict(k_bits=2, v_bits=2, group_size=32, residual_length=W,
          v_flush=32, scale_dtype="float32")


def _np(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _port_np(t):
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _jax_cache(rng, prompt, extra=0):
    """A batch-1 JAX cache holding `prompt` tokens by prefill_ingest, then
    `extra` more by window appends (which may fill the window)."""
    jq = JQuantConfig(**KW)
    c = JC.init_layer_cache(1, H, D, TMAX, jq, dtype=jnp.float32)
    n = lambda t: jnp.asarray(rng.standard_normal((1, H, t, D)),
                              jnp.float32)
    if prompt:
        c = JC.prefill_ingest(c, n(prompt), n(prompt), jq)
    if extra:
        c = JC.window_append_capped(c, n(extra), n(extra))
    return c


def _port_of(jcs, per_row: bool):
    """Batch-1 JAX caches -> one port cache (rows stacked): counters (S,)
    int32 tensors, or host ints (then every JAX cache must agree)."""
    f = {}
    for n in FIELDS:
        a = np.concatenate([np.asarray(getattr(c, n)) for c in jcs])
        f[n] = torch.from_numpy(a.view(np.int32).copy() if a.dtype ==
                                np.uint32 else a.copy())
    vals = {n: [int(getattr(c, n)) for c in jcs] for n in COUNTERS}
    if per_row:
        cnt = {n: torch.tensor(v, dtype=torch.int32) for n, v in vals.items()}
    else:
        assert all(len(set(v)) == 1 for v in vals.values())
        cnt = {n: v[0] for n, v in vals.items()}
    return TC.KiviLayerCache(**f, **cnt)


def _assert_equal(tc, jstack, where):
    """Every field and counter equal; jstack holds the JAX rows stacked
    along a leading slot axis (each a batch-1 cache)."""
    for c in COUNTERS:
        got = getattr(tc, c)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(
            np.broadcast_to(got, np.asarray(getattr(jstack, c)).shape),
            np.asarray(getattr(jstack, c)), err_msg=f"{where} {c}")
    for f in FIELDS:
        np.testing.assert_array_equal(
            _port_np(getattr(tc, f)), _np(getattr(jstack, f))[:, 0],
            err_msg=f"{where} {f}")


@pytest.mark.parametrize("prompt,extra,t1", [
    (40, 0, 5),     # room for the whole block
    (60, 0, 9),     # 28 in the window: 4 fit, 5 dropped
    (64, 0, 9),     # an empty window after an exact flush
    (40, 24, 3),    # a full window: everything dropped
    (0, 0, 9)])     # an empty cache
def test_window_append_capped_host_int_matches_jax(prompt, extra, t1):
    rng = np.random.default_rng(prompt + 7 * extra + t1)
    jcs = [_jax_cache(rng, prompt, extra) for _ in range(2)]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jcs)
    # both rows share their counters (host ints) but not their bytes
    tc = _port_of(jcs, per_row=False)
    k = rng.standard_normal((2, 1, H, t1, D)).astype(np.float32)
    v = rng.standard_normal((2, 1, H, t1, D)).astype(np.float32)
    last_k = tc.k_win[:, :, W - 1].clone()
    full = tc.n_k_win == W
    TC.window_append_capped(tc, torch.from_numpy(k[:, 0]),
                            torch.from_numpy(v[:, 0]))
    jstack = jax.vmap(JC.window_append_capped)(jstack, jnp.asarray(k),
                                               jnp.asarray(v))
    _assert_equal(tc, jstack, f"append {t1}")
    assert tc.n_k_win == min(W, int(jcs[0].n_k_win) + t1)
    if full:          # the last row still holds the newest real token
        torch.testing.assert_close(tc.k_win[:, :, W - 1], last_k,
                                   rtol=0, atol=0)
    # roll back to the prompt: counters only
    TC.rollback_counters(tc, prompt)
    jstack = jax.vmap(lambda c: JC.rollback_counters(c, prompt))(jstack)
    _assert_equal(tc, jstack, "rollback")


def test_window_append_capped_per_row_matches_vmapped_jax():
    """Slots at window fills 8, 28, 32 (full) and 0, slot 2 inactive in
    the first block: three blocks of T1 = 5 appended, each followed by a
    rollback to a per-row count, against jax.vmap of the JAX functions
    with `active=`; every field and counter equal after each call."""
    rng = np.random.default_rng(3)
    jcs = [_jax_cache(rng, 40), _jax_cache(rng, 60), _jax_cache(rng, 40, 24),
           _jax_cache(rng, 64)]
    assert [int(c.n_k_win) for c in jcs] == [8, 28, 32, 0]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jcs)
    tc = _port_of(jcs, per_row=True)
    ptrs = [getattr(tc, f).data_ptr() for f in FIELDS + COUNTERS]
    S, t1 = len(jcs), 5
    append = jax.vmap(lambda c, k, v, a: JC.window_append_capped(
        c, k, v, active=a))
    roll = jax.vmap(JC.rollback_counters)
    for it in range(3):
        act = np.array([True, True, it > 0, True])
        k = rng.standard_normal((S, 1, H, t1, D)).astype(np.float32)
        v = rng.standard_normal((S, 1, H, t1, D)).astype(np.float32)
        before = [int(x) for x in tc.seq_len]
        TC.window_append_capped(tc, torch.from_numpy(k[:, 0]),
                                torch.from_numpy(v[:, 0]),
                                active=torch.from_numpy(act))
        jstack = append(jstack, jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(act))
        _assert_equal(tc, jstack, f"block {it}")
        # commit 1..3 tokens per active row (within what fit), as a
        # speculative step would
        n = np.array([b + (1 + (s + it) % 3 if a else 0)
                      for s, (b, a) in enumerate(zip(before, act))])
        n = np.minimum(n, [int(x) for x in tc.seq_len])
        TC.rollback_counters(tc, torch.from_numpy(n).to(torch.int32),
                             active=torch.from_numpy(act))
        jstack = roll(jstack, jnp.where(jnp.asarray(act), jnp.asarray(n),
                                        jstack.n_k_quant + jstack.n_k_win))
        _assert_equal(tc, jstack, f"rollback {it}")
    assert ptrs == [getattr(tc, f).data_ptr() for f in FIELDS + COUNTERS]


def test_window_append_capped_rejects_active_with_host_ints():
    rng = np.random.default_rng(0)
    tc = _port_of([_jax_cache(rng, 40)], per_row=False)
    x = torch.zeros(1, H, 2, D)
    with pytest.raises(ValueError, match="per-row"):
        TC.window_append_capped(tc, x, x, active=torch.ones(1, dtype=bool))


def test_fp_rollback():
    """The fp cache's rollback is its length (the JAX decoders'
    `dataclasses.replace(c, length=n)`): host int, and per row in place
    with an inactive row keeping its own."""
    c = TF.init_fp_cache(2, H, D, 64, torch.float32, device="cpu")
    c.length = 40
    TF.rollback(c, 33)
    assert c.length == 33
    s = TF.init_fp_slot_cache(3, H, D, 64, torch.float32, device="cpu")
    s.length.copy_(torch.tensor([10, 20, 30]))
    ptr = s.length.data_ptr()
    TF.rollback(s, torch.tensor([5, 15, 25]),
                active=torch.tensor([True, False, True]))
    assert s.length.tolist() == [5, 20, 25] and s.length.data_ptr() == ptr


# ---------------------------------------------------------------------------
# forward(ingest="window")
# ---------------------------------------------------------------------------

def _params():
    jp = JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", torch.float32)


def _qcfgs(bits):
    kw = dict(KW, k_bits=bits, v_bits=bits)
    return QuantConfig(**kw), JQuantConfig(**kw)


def _close_caches(tcs, jcs, where, per_row=False, atol=1e-5):
    """Counters equal; windows / fp stores within atol."""
    for t, j in zip(tcs, jcs):
        for f in (("length",) if isinstance(t, TF.FpLayerCache)
                  else COUNTERS):
            got = getattr(t, f)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            want = np.asarray(getattr(j, f))
            np.testing.assert_array_equal(
                np.broadcast_to(got, want.shape), want, err_msg=where + f)
        for f in (("k", "v") if isinstance(t, TF.FpLayerCache)
                  else ("k_win", "v_win")):
            want = np.asarray(getattr(j, f))
            if per_row:
                want = want[:, 0]
            np.testing.assert_allclose(getattr(t, f).numpy(), want,
                                       atol=atol, rtol=0,
                                       err_msg=where + f)


def _jforward(cfg, qcfg, **static):
    """The JAX forward compiled (the port copies the JAX caches it
    starts from, so jit's reciprocal rewrite of the quantizer, ROADMAP
    Queue 3, touches both sides alike; the window-only steps quantize
    nothing)."""
    return jax.jit(functools.partial(JM.forward, cfg=cfg, qcfg=qcfg,
                                     **static))


def _to_port(rows, per_row: bool):
    """JAX layer caches (one per row, batch 1 each; or one batch-B cache)
    -> one port cache of the same bytes: counters (S,) int32 tensors, or
    host ints.  Both sides then start from the same prefilled state (a
    full forward's prefill can flip a code at a tie, ROADMAP Queue 3)."""
    cls = (TF.FpLayerCache if isinstance(rows[0], JF.FpLayerCache)
           else TC.KiviLayerCache)
    f = {}
    for fld in dataclasses.fields(cls):
        vals = [np.asarray(getattr(c, fld.name)) for c in rows]
        if vals[0].ndim == 0:
            ints = [int(v) for v in vals]
            f[fld.name] = (torch.tensor(ints, dtype=torch.int32) if per_row
                           else ints[0])
        else:
            a = np.concatenate(vals)
            f[fld.name] = torch.from_numpy(a.view(np.int32).copy()
                                           if a.dtype == np.uint32
                                           else a.copy())
    return cls(**f)


@pytest.mark.parametrize("bits,prompt", [(2, 70), (2, 100), (4, 64),
                                         (16, 90)])
def test_forward_window_ingest_matches_jax(bits, prompt):
    """Host-int caches (B = 2) holding the JAX package's prefill (copied
    into the port), then a width-5 verify (extend, every position's
    logits, window-only ingest), a rollback to 2 of its tokens, then
    three decode steps with window-only ingest."""
    tq, jq = _qcfgs(bits)
    jcfg, tcfg = j_tiny_config(), tiny_config()
    jp, tp = _params()
    B, t1 = 2, 5
    rng = np.random.default_rng(bits + prompt)
    toks = rng.integers(0, 256, (B, prompt + t1 + 3))
    pos = np.broadcast_to(np.arange(toks.shape[1]), toks.shape).copy()
    jc = JM.init_caches(jcfg, jq, B, FWD_TMAX, dtype=jnp.float32)
    _, jc = _jforward(jcfg, jq, mode="prefill")(
        jp, jnp.asarray(toks[:, :prompt]), jc,
        positions=jnp.asarray(pos[:, :prompt]))
    tc = [_to_port([c], per_row=False) for c in jc]

    def both(sl, mode, **kw):
        nonlocal jc
        want, jc = _jforward(jcfg, jq, mode=mode, **kw)(
            jp, jnp.asarray(toks[:, sl]), jc,
            positions=jnp.asarray(pos[:, sl]))
        got, _ = TM.forward(tp, torch.from_numpy(toks[:, sl]), tc, tcfg, tq,
                            torch.from_numpy(pos[:, sl]), mode=mode, **kw)
        atol = FP_DECODE_ATOL if bits == 16 and mode == "decode" else 1e-4
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0, err_msg=f"{mode} {sl}")

    both(slice(prompt, prompt + t1), "extend", last_only=False,
         ingest="window")
    _close_caches(tc, jc, "verify ")
    n = prompt + 2
    for c in tc:
        (TF.rollback if isinstance(c, TF.FpLayerCache)
         else TC.rollback_counters)(c, n)
    jc = [dataclasses.replace(c, length=jnp.int32(n))
          if isinstance(c, JF.FpLayerCache)
          else JC.rollback_counters(c, n) for c in jc]
    for i in range(3):
        both(slice(n + i, n + i + 1), "decode", ingest="window")
    # after fp16 decode steps the hidden states (so the appended K/V)
    # differ by the fp-decode oracle's bf16 rounding
    _close_caches(tc, jc, "decode ",
                  atol=FP_DECODE_ATOL if bits == 16 else 1e-5)


@pytest.mark.parametrize("bits", [2, 16])
def test_forward_window_ingest_per_row_matches_vmapped_jax(bits):
    """Slot caches (per-row device counters) at prompts 40, 61 and 20
    (61 leaves 29 keys in the window, so a width-5 block overflows it),
    slot 2 inactive, each slot's JAX prefill copied into the port: a
    verify (extend, window-only ingest, `active=`) then two decode steps,
    against the JAX forward vmapped over batch-1 caches (the JAX
    speculative batcher's form)."""
    tq, jq = _qcfgs(bits)
    jcfg, tcfg = j_tiny_config(), tiny_config()
    jp, tp = _params()
    lens, t1 = (40, 61, 20), 5
    S = len(lens)
    rng = np.random.default_rng(bits)
    prompts = [rng.integers(0, 256, (1, n)) for n in lens]
    jcs = []
    for s, p in enumerate(prompts):
        c = JM.init_caches(jcfg, jq, 1, FWD_TMAX, dtype=jnp.float32)
        _, c = _jforward(jcfg, jq, mode="prefill")(
            jp, jnp.asarray(p), c, positions=jnp.arange(p.shape[1])[None])
        jcs.append(c)
    tc = [_to_port([c[i] for c in jcs], per_row=True)
          for i in range(len(jcs[0]))]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jcs)
    act = np.array([True, True, False])

    def one_slot(tok, pos, c, a, mode, **kw):
        return JM.forward(jp, tok[None], c, jcfg, jq, pos[None], mode=mode,
                          active=a, ingest="window", **kw)

    def slots(mode, **kw):
        return jax.jit(jax.vmap(
            lambda t, p, c, a: one_slot(t, p, c, a, mode, **kw)))

    blocks = [rng.integers(0, 256, (S, t1)), rng.integers(0, 256, (S, 1)),
              rng.integers(0, 256, (S, 1))]
    n0 = np.array(lens)
    for i, blk in enumerate(blocks):
        mode = "extend" if i == 0 else "decode"
        kw = {"last_only": False} if i == 0 else {}
        off = 0 if i == 0 else t1 + i - 1
        pos = n0[:, None] + off + np.arange(blk.shape[1])[None]
        want, jstack = slots(mode, **kw)(
            jnp.asarray(blk), jnp.asarray(pos), jstack, jnp.asarray(act))
        got, _ = TM.forward(tp, torch.from_numpy(blk), tc, tcfg, tq,
                            torch.from_numpy(pos), mode=mode,
                            active=torch.from_numpy(act),
                            ingest="window", **kw)
        want = np.asarray(want)[:, 0]
        atol = (FP_DECODE_ATOL if bits == 16 and mode == "decode"
                else 1e-4)
        np.testing.assert_allclose(got.numpy()[act], want[act],
                                   atol=atol, rtol=0,
                                   err_msg=f"{mode} {i}")
        _close_caches(tc, jstack, f"{mode} {i} ", per_row=True,
                      atol=FP_DECODE_ATOL if bits == 16 and i else 1e-5)
    if bits != 16:
        assert int(tc[0].n_k_win[1]) == W      # slot 1's window filled up
