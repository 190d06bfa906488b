"""The port's KIVI cache (kivi_tpu_torch.cache.kivi_cache, CPU) against
the JAX package's kivi_tpu.cache.kivi_cache, stage by stage: prefill
ingest, chunked prefill_extend, then decode appends with the flushes of
the static schedule.

Tolerance: every field equal (packed words compared as uint32, bf16
scales and windows compared exactly) and every counter equal — both
sides quantize the same f32 inputs with the same operations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.cache import kivi_cache as TC
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.serving.engine import flush_schedule

torch.set_num_threads(2)

FIELDS = ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
          "k_win", "v_win")
COUNTERS = ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win")
B, H, D, TMAX = 2, 2, 64, 768


def assert_cache_equal(tc, jc, where=""):
    for c in COUNTERS:
        assert getattr(tc, c) == int(getattr(jc, c)), (where, c)
    for f in FIELDS:
        t, j = getattr(tc, f), np.asarray(getattr(jc, f))
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy().view(np.uint32), j,
                                          err_msg=f"{where} {f}")
        else:
            np.testing.assert_array_equal(t.float().numpy(),
                                          j.astype(np.float32),
                                          err_msg=f"{where} {f}")


def _qcfgs(vf, bits=(2, 4)):
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=32,
              residual_length=128, v_flush=vf)
    return QuantConfig(**kw), JQuantConfig(**kw)


def _kv(rng, T):
    k = rng.standard_normal((B, H, T, D)).astype(np.float32)
    v = rng.standard_normal((B, H, T, D)).astype(np.float32)
    return k, v


def _both(k, v):
    return (torch.from_numpy(k), torch.from_numpy(v), jnp.asarray(k),
            jnp.asarray(v))


@pytest.mark.parametrize("vf", [32, 128])
@pytest.mark.parametrize("prompt,chunk,steps", [(200, 128, 140),
                                                (256, 128, 140)])
def test_cache_stages_match_jax(vf, prompt, chunk, steps):
    tq, jq = _qcfgs(vf)
    rng = np.random.default_rng(prompt + vf)
    k, v = _kv(rng, prompt)
    tk, tv, jk, jv = _both(k, v)

    # one-shot ingest
    tcache = TC.prefill_ingest(
        TC.init_layer_cache(B, H, D, TMAX, tq, device="cpu"), tk, tv, tq)
    jcache = JC.prefill_ingest(JC.init_layer_cache(B, H, D, TMAX, jq),
                               jk, jv, jq)
    assert_cache_equal(tcache, jcache, "ingest")

    # chunked extend, compared after every chunk
    tcache = TC.init_layer_cache(B, H, D, TMAX, tq, device="cpu")
    jcache = JC.init_layer_cache(B, H, D, TMAX, jq)
    for t0 in range(0, prompt, chunk):
        sl = slice(t0, t0 + chunk)
        TC.prefill_extend(tcache, tk[:, :, sl], tv[:, :, sl], tq, t0)
        jcache = JC.prefill_extend(jcache, jk[:, :, sl], jv[:, :, sl], jq,
                                   t0)
        assert_cache_equal(tcache, jcache, f"extend@{t0}")

    # decode on the static flush schedule
    events = flush_schedule(tq, prompt, steps)
    assert events == JEngine._flush_schedule(jq, prompt, steps)
    jstep = jax.jit(lambda c, a, b: JC.decode_append(c, a, b, jq,
                                                     do_flush=False))
    kd, vd = _kv(rng, steps)
    for i in range(steps):
        if i in events:
            fk, fv = events[i]
            if fk:
                TC.flush_k_now(tcache, tq)
                jcache = JC.flush_k_now(jcache, jq)
            if fv:
                TC.flush_v_now(tcache, tq)
                jcache = JC.flush_v_now(jcache, jq)
            assert_cache_equal(tcache, jcache, f"flush@{i}")
        tkd, tvd, jkd, jvd = _both(kd[:, :, i:i + 1], vd[:, :, i:i + 1])
        TC.decode_append(tcache, tkd, tvd, tq, do_flush=False)
        jcache = jstep(jcache, jkd, jvd)
    assert_cache_equal(tcache, jcache, "decode")
    assert any(fk for fk, _ in events.values())
    assert any(fv for _, fv in events.values())


def test_init_layer_cache_defaults_to_cuda():
    """Without `device` the cache goes to CUDA; without CUDA that is an
    error, never a silent cache on the host."""
    tq, _ = _qcfgs(128)
    if torch.cuda.is_available():
        assert TC.init_layer_cache(B, H, D, TMAX, tq).k_codes.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TC.init_layer_cache(B, H, D, TMAX, tq)


@pytest.mark.parametrize("vf", [32, 128])
def test_decode_append_own_flushes_match_jax(vf):
    """decode_append(do_flush=True) checks the windows itself."""
    tq, jq = _qcfgs(vf, bits=(4, 2))
    rng = np.random.default_rng(vf)
    k, v = _kv(rng, 100)
    tk, tv, jk, jv = _both(k, v)
    tcache = TC.prefill_ingest(
        TC.init_layer_cache(B, H, D, TMAX, tq, device="cpu"), tk, tv, tq)
    jcache = JC.prefill_ingest(JC.init_layer_cache(B, H, D, TMAX, jq),
                               jk, jv, jq)
    kd, vd = _kv(rng, 170)
    # eager JAX: compiled XLA rewrites `/ max_int` into a reciprocal
    # multiply, so jitted scales can differ from quantize_last by an ulp
    with jax.disable_jit():
        for i in range(170):
            tkd, tvd, jkd, jvd = _both(kd[:, :, i:i + 1],
                                       vd[:, :, i:i + 1])
            TC.decode_append(tcache, tkd, tvd, tq)
            jcache = JC.decode_append(jcache, jkd, jvd, jq)
    assert_cache_equal(tcache, jcache, "decode")


@pytest.mark.parametrize("vf", [32, 128])
@pytest.mark.parametrize("chunks", [(128, 128, 128), (64, 200, 90)])
def test_prefill_extend_equals_ingest(vf, chunks):
    """Chunked extend ends bit-identical to one prefill_ingest of the
    whole prompt (kivi_tpu/cache/kivi_cache.py:222-226)."""
    tq, _ = _qcfgs(vf)
    T = sum(chunks)
    k, v = _kv(np.random.default_rng(T), T)
    # bf16 inputs: the window round-trips bf16 -> bf16 losslessly
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    one = TC.prefill_ingest(
        TC.init_layer_cache(B, H, D, TMAX, tq, device="cpu"), tk, tv, tq)
    ext = TC.init_layer_cache(B, H, D, TMAX, tq, device="cpu")
    t0 = 0
    for n in chunks:
        TC.prefill_extend(ext, tk[:, :, t0:t0 + n], tv[:, :, t0:t0 + n],
                          tq, t0)
        t0 += n
    for c in COUNTERS:
        assert getattr(ext, c) == getattr(one, c), c
    for f in FIELDS:
        assert torch.equal(getattr(ext, f), getattr(one, f)), f


# ---------------------------------------------------------------------------
# masked, per-row updates of a slot cache (the continuous batcher's decode)
# ---------------------------------------------------------------------------

SW, STMAX = 64, 256          # window and capacity of the slot tests


def _slot_port(jcs):
    """Batch-1 JAX caches -> one port slot cache (rows stacked, counters
    (S,) int32 tensors)."""
    f = {}
    for n in FIELDS:
        a = np.concatenate([np.asarray(getattr(c, n)) for c in jcs])
        f[n] = (torch.from_numpy(a.view(np.int32).copy())
                if a.dtype == np.uint32 else torch.from_numpy(a.copy()))
    cnt = {n: torch.tensor([int(getattr(c, n)) for c in jcs],
                           dtype=torch.int32) for n in COUNTERS}
    return TC.KiviLayerCache(**f, **cnt)


def assert_slots_equal(tc, jstack, where=""):
    for c in COUNTERS:
        np.testing.assert_array_equal(getattr(tc, c).numpy(),
                                      np.asarray(getattr(jstack, c)),
                                      err_msg=f"{where} {c}")
    for f in FIELDS:
        t, j = getattr(tc, f), np.asarray(getattr(jstack, f))[:, 0]
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy().view(np.uint32), j,
                                          err_msg=f"{where} {f}")
        else:
            np.testing.assert_array_equal(t.numpy(), j,
                                          err_msg=f"{where} {f}")


@pytest.mark.parametrize("bits,vf", [((2, 4), 32), ((8, 2), 64)])
def test_decode_append_masked_matches_vmapped_jax(bits, vf):
    """S slots at divergent window phases through decode_append_masked,
    against jax.vmap(kivi_cache.decode_append_masked) over batch-1
    caches, bit for bit after every step.  Slot 1 sits inactive at
    n_k_win == W (its clamped append must carry its own bytes); slot 2
    starts with a full K store (n_k_quant == Tmax: every masked write
    clamps to the store's last slice, as XLA's dynamic_update_slice
    does); slot 0 pauses for ten steps; the run crosses K and V flushes."""
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=32,
              residual_length=SW, v_flush=vf, scale_dtype="float32")
    tq, jq = QuantConfig(**kw), JQuantConfig(**kw)
    rng = np.random.default_rng(sum(bits) + vf)
    n = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    step1 = jax.jit(lambda c, k, v: JC.decode_append(c, k, v, jq))
    jcs = []
    for prompt, steps in [(100, 0), (40, 24), (STMAX, 0), (20, 0)]:
        c = JC.init_layer_cache(1, H, D, STMAX, jq, dtype=jnp.float32)
        if prompt:
            c = JC.prefill_ingest(c, n(1, H, prompt, D), n(1, H, prompt, D),
                                  jq)
        for _ in range(steps):
            c = step1(c, n(1, H, 1, D), n(1, H, 1, D))
        jcs.append(c)
    assert int(jcs[1].n_k_win) == SW and int(jcs[2].n_k_quant) == STMAX
    tcache = _slot_port(jcs)
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jcs)
    S = len(jcs)
    jstep = jax.vmap(lambda c, k, v, a: JC.decode_append_masked(
        c, k, v, jq, active=a))
    steps = 50
    kd = rng.standard_normal((steps, S, 1, H, 1, D)).astype(np.float32)
    vd = rng.standard_normal((steps, S, 1, H, 1, D)).astype(np.float32)
    flushed = np.zeros(S, bool)
    # eager JAX quantizer (see test_decode_append_own_flushes_match_jax)
    with jax.disable_jit():
        for i in range(steps):
            act = np.array([not 30 <= i < 40, False, True, True])
            before = tcache.n_k_quant.clone()
            TC.decode_append_masked(tcache, torch.from_numpy(kd[i][:, 0]),
                                    torch.from_numpy(vd[i][:, 0]), tq,
                                    active=torch.from_numpy(act))
            jstack = jstep(jstack, jnp.asarray(kd[i]), jnp.asarray(vd[i]),
                           jnp.asarray(act))
            flushed |= (tcache.n_k_quant != before).numpy()
            assert_slots_equal(tcache, jstack, f"step {i}")
    assert flushed[0] and flushed[3]             # K flushes crossed
    assert int(tcache.n_k_win[1]) == SW          # the inactive row froze
    assert tcache.n_v_quant[0] > int(jcs[0].n_v_quant)   # V flushes too


def test_write_slot_and_slot_counters():
    """write_slot copies a batch-1 host-int cache into one row and sets
    its counters; the other rows stay as they were."""
    tq, _ = _qcfgs(128)
    rng = np.random.default_rng(5)
    k, v = _kv(rng, 300)
    one = TC.prefill_ingest(
        TC.init_layer_cache(1, H, D, TMAX, tq, device="cpu"),
        torch.from_numpy(k[:1]), torch.from_numpy(v[:1]), tq)
    slots = TC.init_slot_cache(3, H, D, TMAX, tq, device="cpu")
    assert slots.n_k_quant.dtype == torch.int32
    TC.write_slot(slots, 1, one)
    assert slots.seq_len.tolist() == [0, 300, 0]
    for c in COUNTERS:
        assert getattr(slots, c).tolist()[1] == getattr(one, c)
    for f in FIELDS:
        assert torch.equal(getattr(slots, f)[1], getattr(one, f)[0]), f
        assert not getattr(slots, f)[0].any() and \
            not getattr(slots, f)[2].any(), f
