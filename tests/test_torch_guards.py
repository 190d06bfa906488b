"""The port's debug mode (kivi_tpu_torch.utils.guards, Engine(debug=True),
CPU) against the JAX package's (kivi_tpu.utils.guards, checkify),
mirroring tests/test_guards.py:

  * a clean debug run gives the plain run's greedy tokens and the JAX
    debug engine's (equal tokens: the same f32 weights over f32 caches,
    as tests/test_torch_engine.py);
  * a NaN in the weights raises in both packages;
  * a violated fill bound raises "t_bound violated" in both, for the
    KIVI decode (host-int and per-row device counters) and the fp decode;
    a valid one passes and matches the JAX oracle (3e-2, the JAX test's
    tolerance against its own oracle);
  * debug decode is the non-debug step run eagerly (`_decode_body`, once
    a step, over device counters), and a flush schedule that does not
    match the caches raises: a skipped flush under debug, a flush of a
    window that is not full under debug, a prompt_len that is not the
    caches' fill always;
  * outside a checked call, debug_check and check_finite do nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.checkify import JaxRuntimeError

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.core.attention import decode_attention
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving import engine as TE
from kivi_tpu_torch.serving.engine import Engine
from kivi_tpu_torch.utils import guards

torch.set_num_threads(2)

KW = dict(k_bits=2, v_bits=2, group_size=32, residual_length=32,
          scale_dtype="float32")
WIDE = dict(k_bits=2, v_bits=2, group_size=32, residual_length=128,
            v_flush=128)


@pytest.fixture(autouse=True)
def _exact_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _params():
    jp = JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", torch.float32)


def _engines(jp, tp, debug):
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**KW), params=jp,
                   max_seq_len=128, batch_size=1, debug=debug)
    jeng.cache_dtype = jnp.float32
    teng = Engine(tiny_config(), QuantConfig(**KW), tp, max_seq_len=128,
                  batch_size=1, device="cpu", cache_dtype=torch.float32,
                  debug=debug)
    return jeng, teng


def test_debug_clean_run_matches_plain_and_jax():
    jp, tp = _params()
    toks = np.random.RandomState(0).randint(1, 256, size=(1, 40))
    jdbg, tdbg = _engines(jp, tp, True)
    _, tplain = _engines(jp, tp, False)
    want = np.asarray(jdbg.generate(jnp.asarray(toks, jnp.int32), 30))
    got = tdbg.generate(torch.from_numpy(toks), 30)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tplain.generate(torch.from_numpy(toks), 30).numpy(), want)


def test_debug_catches_nan_weights():
    jp, tp = _params()
    jp["layers"]["wq"] = jp["layers"]["wq"].at[0, 0, 0].set(jnp.nan)
    tp["layers"][0]["wq"][0, 0] = float("nan")
    jeng, teng = _engines(jp, tp, True)
    with pytest.raises((JaxRuntimeError, ValueError), match="nan"):
        jeng.generate(jnp.ones((1, 16), jnp.int32), 4)
    with pytest.raises(guards.GuardError, match="nan") as e:
        teng.generate(torch.ones((1, 16), dtype=torch.int64), 4)
    # q of layer 0 is NaN, so its attention output is; layer 1's keys
    # are the first appended values to carry it
    assert "layer 1: the keys appended" in str(e.value)
    # without debug the NaN reaches the tokens silently
    _, plain = _engines(jp, tp, False)
    plain.generate(torch.ones((1, 16), dtype=torch.int64), 4)


def test_debug_decode_is_the_replayed_body(monkeypatch):
    """Engine(debug=True) decodes through the step a CUDA graph replays,
    once a step, as a checked call: the checks are staged inside it."""
    jp, tp = _params()
    _, teng = _engines(jp, tp, True)
    staged = []
    body = teng._decode_body

    def spy(*a):
        staged.append(guards.checking())
        return body(*a)

    monkeypatch.setattr(teng, "_decode_body", spy)
    teng.generate(torch.ones((1, 40), dtype=torch.int64), 30)
    assert staged == [True] * 29


def _prefilled(debug):
    jp, tp = _params()
    teng = _engines(jp, tp, debug)[1]
    toks = torch.from_numpy(np.random.RandomState(0).randint(1, 256,
                                                             (1, 40)))
    first, caches = teng.prefill(toks)
    return teng, first, caches, torch.tensor([[40]])


@pytest.mark.parametrize("events,match", [
    ({}, "window full: a scheduled flush was skipped"),
    ({0: (True, False)}, "flush schedule violated: layer 0"),
    ({0: (False, True)}, "flush schedule violated: layer 0")])
def test_debug_catches_a_wrong_flush_schedule(monkeypatch, events, match):
    """40 prompt tokens leave 8 in each window of 32: no flush is due
    before step 0, and 24 steps fill the windows.  A schedule with no
    flushes overflows them; one that flushes at step 0 quantizes a
    window of 8."""
    monkeypatch.setattr(TE, "flush_schedule", lambda *a: events)
    teng, first, caches, pos = _prefilled(True)
    with pytest.raises(guards.GuardError, match=match):
        teng.decode(first, pos, caches, steps=30, prompt_len=40)


def test_decode_refuses_a_prompt_len_that_is_not_the_fill():
    """The flush schedule and the fill bound stand on prompt_len; the
    caches' fill is a host int before the decode, so this holds with or
    without debug."""
    for debug in (False, True):
        teng, first, caches, pos = _prefilled(debug)
        with pytest.raises(AssertionError, match="not prompt_len 41"):
            teng.decode(first, pos, caches, steps=4, prompt_len=41)


def _jax_cache(prompt_len, B=1, H=4, D=128, Tmax=1024):
    from kivi_tpu.cache.kivi_cache import init_layer_cache, prefill_ingest
    qcfg = JQuantConfig(**WIDE)
    ks = jax.random.split(jax.random.PRNGKey(1), 2)
    cache = init_layer_cache(B, H, D, Tmax, qcfg)
    k = jax.random.normal(ks[0], (B, H, prompt_len, D), jnp.float32)
    v = jax.random.normal(ks[1], (B, H, prompt_len, D), jnp.float32)
    return prefill_ingest(cache, k, v, qcfg)


def _port_cache(jc, per_row: bool):
    """The JAX cache's bits in the port's layout; per_row: its counters
    as (B,) int32 tensors (the form the engine's replayed step reads)."""
    def t(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return torch.from_numpy(a.view(np.int32).copy())
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32)
    c = KC.KiviLayerCache(
        **{n: t(getattr(jc, n)) for n in (
            "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
            "k_win", "v_win")},
        **{n: int(getattr(jc, n)) for n in KC._COUNTERS})
    if per_row:
        KC.counters_to_device([c])
    return c


@pytest.mark.parametrize("per_row", [False, True])
def test_debug_catches_violated_t_bound(per_row):
    """fill_bound=0 under a 700-token cache (n_k_quant 640): the JAX
    wide kernel's t_bound and the port's both fall to 256-512, below
    the fill, and a checked call raises."""
    from jax.experimental import checkify

    from kivi_tpu.core.attention import decode_attention as j_decode
    from kivi_tpu.utils.guards import checked_jit
    jc = _jax_cache(700)
    q = jax.random.normal(jax.random.PRNGKey(2), (1, 8, 1, 128),
                          jnp.float32)
    bad = checked_jit(lambda qq, cc: j_decode(
        qq, cc, JQuantConfig(**WIDE), impl="pallas", fill_bound=0),
        errors=checkify.user_checks)
    with pytest.raises(JaxRuntimeError, match="t_bound violated"):
        bad(q, jc)
    tc = _port_cache(jc, per_row)
    tq = torch.from_numpy(np.asarray(q))
    call = guards.checked_call(decode_attention)
    with pytest.raises(guards.GuardError, match="t_bound violated"):
        call(tq, tc, QuantConfig(**WIDE), fill_bound=0)


@pytest.mark.parametrize("per_row", [False, True])
def test_debug_valid_t_bound_passes_and_matches(per_row):
    from kivi_tpu.core.attention import decode_attention as j_decode
    jc = _jax_cache(300)
    q = jax.random.normal(jax.random.PRNGKey(2), (1, 8, 1, 128),
                          jnp.float32)
    ref = np.asarray(j_decode(q, jc, JQuantConfig(**WIDE), impl="jnp"))
    tc = _port_cache(jc, per_row)
    got = guards.checked_call(decode_attention)(
        torch.from_numpy(np.asarray(q)), tc, QuantConfig(**WIDE),
        fill_bound=300)
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-2, atol=3e-2)


def test_fp_debug_catches_violated_t_bound():
    """The fp decode's contract (kivi_tpu/cache/fp_cache.py:167-178):
    length 700 against a fill bound of 256 (the port's t_bound 512)."""
    from jax.experimental import checkify

    from kivi_tpu.cache import fp_cache as JFC
    from kivi_tpu.utils.guards import checked_jit
    k = jax.random.normal(jax.random.PRNGKey(3), (1, 2, 700, 128),
                          jnp.float32)
    jc = JFC.fp_append(JFC.init_fp_cache(1, 2, 128, 1024, jnp.float32),
                       k, k)
    q = jax.random.normal(jax.random.PRNGKey(4), (1, 4, 1, 128),
                          jnp.float32)
    bad = checked_jit(lambda qq, cc: JFC.fp_decode_attention(
        qq, cc, impl="pallas", fill_bound=256),
        errors=checkify.user_checks)
    with pytest.raises(JaxRuntimeError, match="t_bound violated"):
        bad(q, jc)
    tc = FC.init_fp_slot_cache(1, 2, 128, 1024, torch.float32, "cpu")
    kt = torch.from_numpy(np.asarray(k))
    FC.fp_append_masked(tc, kt, kt)
    call = guards.checked_call(FC.fp_decode_attention)
    tq = torch.from_numpy(np.asarray(q))
    with pytest.raises(guards.GuardError, match="t_bound violated"):
        call(tq, tc, fill_bound=256)
    call(tq, tc, fill_bound=700)


def test_no_op_outside_checked_call(monkeypatch):
    """Outside a checked call nothing is checked and nothing computed:
    check_finite never reaches torch.isfinite, and a violated bound
    passes silently (the documented contract)."""
    def boom(*a, **k):
        raise AssertionError("computed outside a checked call")

    guards.debug_check(False, "never")
    guards.debug_check(torch.tensor(False), "never")
    monkeypatch.setattr(torch, "isfinite", boom)
    guards.check_finite(torch.tensor([float("nan")]), "x")
    monkeypatch.undo()
    assert not guards.checking()
    tc = _port_cache(_jax_cache(700), True)
    decode_attention(torch.zeros((1, 8, 1, 128)), tc, QuantConfig(**WIDE),
                     fill_bound=0)
    with pytest.raises(guards.GuardError, match="never"):
        guards.checked_call(guards.debug_check)(False, "never")
