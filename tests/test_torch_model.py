"""The port's model (kivi_tpu_torch.models, CPU) against the JAX package's
kivi_tpu.models.modeling: the same f32 weights (params_from_jax), one
chunked-prefill extend step and decode steps across window flushes, and
one-shot prefill into the KIVI and the fp16 cache.

Tolerance: logits atol 1e-4 in f32.  The caches keep f32 windows and
scales here: with bf16 windows, an activation that the two libraries sum
to f32 values one ulp apart can round to bf16 values one bf16 ulp apart,
which moves later logits by ~1e-4.  The JAX
side runs with jit disabled: compiled XLA rewrites the quantizer's
`/ (2**bits - 1)` into a reciprocal multiply, so its flushed scales can
differ from kivi_tpu.core.quant.quantize_last by an ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu_torch.cache.fp_cache import FpLayerCache
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.core import quant as TQ
from kivi_tpu_torch.models import modeling as TM
from kivi_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

B, TMAX = 2, 512


def _params(cfg):
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                         torch.float32)
    return jp, tp


@pytest.mark.parametrize("bits,vf,prompt,steps", [((2, 2), 128, 250, 10),
                                                  ((4, 8), 32, 230, 40)])
def test_forward_extend_then_decode_matches_jax(bits, vf, prompt, steps):
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=32,
              residual_length=128, v_flush=vf, scale_dtype="float32")
    tq, jq = QuantConfig(**kw), JQuantConfig(**kw)
    jcfg, tcfg = j_tiny_config(), tiny_config()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(prompt)
    toks = rng.integers(0, jcfg.vocab_size, (B, prompt + steps))
    pos = np.broadcast_to(np.arange(prompt + steps), toks.shape).copy()

    jc = JM.init_caches(jcfg, jq, B, TMAX, dtype=jnp.float32)
    tc = TM.init_caches(tcfg, tq, B, TMAX, dtype=torch.float32,
                        device="cpu")
    with jax.disable_jit():
        want, jc = JM.forward(jp, jnp.asarray(toks[:, :prompt]), jc, jcfg,
                              jq, jnp.asarray(pos[:, :prompt]),
                              mode="extend", prev_len=0)
        got, tc = TM.forward(tp, torch.from_numpy(toks[:, :prompt]), tc,
                             tcfg, tq, torch.from_numpy(pos[:, :prompt]),
                             mode="extend", prev_len=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
        for i in range(prompt, prompt + steps):
            sl = slice(i, i + 1)
            want, jc = JM.forward(jp, jnp.asarray(toks[:, sl]), jc, jcfg,
                                  jq, jnp.asarray(pos[:, sl]),
                                  mode="decode")
            got, tc = TM.forward(tp, torch.from_numpy(toks[:, sl]), tc,
                                 tcfg, tq, torch.from_numpy(pos[:, sl]),
                                 mode="decode")
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0, err_msg=f"@{i}")
    assert tc[0].n_k_quant == int(jc[0].n_k_quant) > 0
    assert tc[0].n_v_quant == int(jc[0].n_v_quant) > 0


def test_forward_extend_with_pad_matches_jax():
    """Left-padded rows: pad slots' K/V are zeroed before ingest and
    masked in attention, over two chunks."""
    kw = dict(k_bits=2, v_bits=2, group_size=32, residual_length=128,
              v_flush=128, scale_dtype="float32")
    tq, jq = QuantConfig(**kw), JQuantConfig(**kw)
    jcfg, tcfg = j_tiny_config(), tiny_config()
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(1).integers(0, 256, (B, 256))
    pad = np.array([0, 150])
    jc = JM.init_caches(jcfg, jq, B, TMAX, dtype=jnp.float32)
    tc = TM.init_caches(tcfg, tq, B, TMAX, dtype=torch.float32,
                        device="cpu")
    with jax.disable_jit():
        for t0 in (0, 128):
            p = np.maximum(t0 + np.arange(128)[None] - pad[:, None], 0)
            want, jc = JM.forward(
                jp, jnp.asarray(toks[:, t0:t0 + 128]), jc, jcfg, jq,
                jnp.asarray(p), mode="extend", prev_len=t0,
                pad_len=jnp.asarray(pad, jnp.int32),
                prev_pos=jnp.int32(t0), last_only=True)
            got, tc = TM.forward(
                tp, torch.from_numpy(toks[:, t0:t0 + 128]), tc, tcfg, tq,
                torch.from_numpy(p), mode="extend", prev_len=t0,
                pad_len=torch.from_numpy(pad), last_only=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["none", "linear", "llama3"])
def test_rope_cos_sin_matches_jax(kind):
    over = {}
    if kind == "linear":
        over = dict(rope_scaling=8.0)
    elif kind == "llama3":
        over = dict(rope_scaling=8.0, rope_scaling_kind="llama3",
                    rope_original_max_position=64)
    jcfg = j_tiny_config(head_dim=64, **over)
    tcfg = tiny_config(head_dim=64, **over)
    pos = np.arange(0, 3000, 7).reshape(3, -1)
    jc, js = JM.rope_cos_sin(jnp.asarray(pos), 64, 10000.0,
                             jcfg.rope_scaling, cfg=jcfg)
    tc, ts = TM.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0,
                             tcfg.rope_scaling, cfg=tcfg)
    # pow differs by an ulp of inv_freq between the libraries; at
    # position p the angle then moves by ~p * ulp (~1e-4 at p = 3000)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-4)
    x = np.random.default_rng(4).standard_normal((3, 2, pos.shape[1], 64))
    x = x.astype(np.float32)
    # apply_rope on the same angles
    c, s = torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(js))
    np.testing.assert_allclose(
        TM.apply_rope(torch.from_numpy(x), c[:, None], s[:, None]).numpy(),
        np.asarray(JM.apply_rope(jnp.asarray(x), jc[:, None], js[:, None])),
        atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_mlp_match_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    # f32: the mean and rsqrt may differ by an ulp between libraries;
    # bf16: the outputs round to the same values
    np.testing.assert_allclose(
        TM.rms_norm(tx, tw, 1e-5).float().numpy(),
        np.asarray(JM.rms_norm(jx, jw, 1e-5)).astype(np.float32),
        rtol=1e-6 if dtype == "float32" else 0, atol=0)
    if dtype == "float32":
        wg, wu = (rng.standard_normal((64, 96)).astype(np.float32)
                  for _ in range(2))
        wd = rng.standard_normal((96, 64)).astype(np.float32)
        np.testing.assert_allclose(
            TM.swiglu_mlp(tx, *map(torch.from_numpy, (wg, wu, wd))).numpy(),
            np.asarray(JM.swiglu_mlp(jx, *map(jnp.asarray, (wg, wu, wd)))),
            atol=1e-4, rtol=1e-5)


def _cache_fields_equal(tc, jc, qcfg, where):
    """Counters equal; float fields within 1e-5 (f32 activations summed
    in a different order by two libraries differ by a few ulps).  Packed
    codes: equal in at least 99.9% of the words; where such an ulp
    difference straddles a rounding boundary a code moves by one step,
    so the dequantized stores agree within one step (at most the largest
    scale) + 1e-5."""
    for c in ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win", "length"):
        if hasattr(tc, c):
            assert getattr(tc, c) == int(getattr(jc, c)), (where, c)
    for f in ("k_scale", "k_mn", "v_scale", "v_mn", "k_win", "v_win", "k",
              "v"):
        if hasattr(tc, f):
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       np.asarray(getattr(jc, f)),
                                       atol=1e-5, rtol=0,
                                       err_msg=f"{where} {f}")
    if not hasattr(tc, "k_codes"):
        return
    gs = qcfg.group_size
    for kind, bits in (("k", qcfg.k_bits), ("v", qcfg.v_bits)):
        t = getattr(tc, f"{kind}_codes")
        j = torch.from_numpy(
            np.asarray(getattr(jc, f"{kind}_codes")).view(np.int32))
        assert (t == j).float().mean() >= 0.999, (where, kind)
        deq = TQ.dequantize_k if kind == "k" else TQ.dequantize_v
        sc, mn = getattr(tc, f"{kind}_scale"), getattr(tc, f"{kind}_mn")
        err = (deq(t, sc, mn, gs, bits) - deq(j, sc, mn, gs, bits)).abs()
        assert err.max() <= sc.abs().max() + 1e-5, (where, kind)


@pytest.mark.parametrize("bits,vf", [((2, 2), 128), ((4, 8), 32),
                                     ((16, 16), 32)])
@pytest.mark.parametrize("pad", [None, (0, 37)])
def test_forward_prefill_matches_jax(bits, vf, pad):
    """mode="prefill" over the KIVI cache (prefill_ingest after exact
    attention) and the fp16 cache (16 bits: fp_append): logits, and every
    cache field and counter after ingest.  With pad, row 1's first 37
    slots are zeroed before ingest and masked in attention."""
    kw = dict(k_bits=bits[0], v_bits=bits[1], group_size=32,
              residual_length=128, v_flush=vf, scale_dtype="float32")
    tq, jq = QuantConfig(**kw), JQuantConfig(**kw)
    jcfg, tcfg = j_tiny_config(), tiny_config()
    jp, tp = _params(jcfg)
    T = 250
    toks = np.random.default_rng(T).integers(0, jcfg.vocab_size, (B, T))
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    jpad = tpad = None
    if pad is not None:
        pos = np.maximum(pos - np.array(pad)[:, None], 0)
        jpad = jnp.asarray(pad, jnp.int32)
        tpad = torch.tensor(pad)
    jc = JM.init_caches(jcfg, jq, B, TMAX, dtype=jnp.float32)
    tc = TM.init_caches(tcfg, tq, B, TMAX, dtype=torch.float32,
                        device="cpu")
    with jax.disable_jit():
        want, jc = JM.forward(jp, jnp.asarray(toks), jc, jcfg, jq,
                              jnp.asarray(pos), mode="prefill",
                              pad_len=jpad)
    got, tc = TM.forward(tp, torch.from_numpy(toks), tc, tcfg, tq,
                         torch.from_numpy(pos), mode="prefill",
                         pad_len=tpad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    for i, (t, j) in enumerate(zip(tc, jc)):
        _cache_fields_equal(t, j, tq, f"layer {i}")
    assert tc[0].seq_len == T


def test_unported_modes_raise():
    """What the model still refuses: an unknown mode, and one-shot
    prefill onto a cache that already holds tokens.  (The fp16 cache and
    mode="prefill", refused before, are held to JAX above.)"""
    cfg = tiny_config()
    q = QuantConfig()
    fp = TM.init_caches(cfg, dataclasses.replace(q, k_bits=16, v_bits=16),
                        1, 128, device="cpu")
    assert all(isinstance(c, FpLayerCache) for c in fp)
    tp = TM.init_params(cfg, device="cpu", dtype=torch.float32)
    caches = TM.init_caches(cfg, q, 1, 128, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError):
        TM.forward(tp, toks, caches, cfg, q, toks, mode="verify")
    TM.forward(tp, toks, caches, cfg, q, toks, mode="prefill")
    with pytest.raises(AssertionError):
        TM.forward(tp, toks, caches, cfg, q, toks, mode="prefill")
