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
