"""The long-context batch-1 slice end to end on the CPU: the port's
Engine in the reference's example cache configuration (KIVI-2, group
32, residual 32, v_flush 32) on a Llama-3.1-shaped tiny model (GQA r =
4, llama3 RoPE scaling), one left-padded prompt prefilled in chunks,
then greedy decode, against the JAX package's Engine(impl="jnp").

`SPLIT_MIN_HISTORY` is lowered so that, at these small sizes, the later
prefill chunks take the qhist extend route and every decode step over
host-int counters (`decode_step`) the split decode route, as a 12K
prompt does at full size; `generate()`'s decode over device counters
(the step a CUDA graph replays on the card, and the same step run
eagerly under `Engine(debug=True)`) takes the per-row fused kernel
instead.  A spy on the module's kernel wrappers shows which routes
ran.

Tolerances: greedy tokens equal; teacher-forced logits (prefill, then
every decode step fed the JAX engine's tokens) within 1e-4 absolute.
Both engines run the same f32 weights over f32 windows and scales, so
the logits differ by float32 rounding only.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.core import attention as TA
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving import engine as TE
from kivi_tpu_torch.serving.engine import Engine

torch.set_num_threads(2)

TMAX, PROMPT, PAD, CHUNK, NEW = 384, 200, 24, 32, 40
MODEL = dict(head_dim=64, num_heads=8, num_kv_heads=2, rope_scaling=8.0,
             rope_scaling_kind="llama3", rope_original_max_position=64,
             max_position_embeddings=1024)
QUANT = dict(k_bits=2, v_bits=2, group_size=32, residual_length=32,
             v_flush=32, scale_dtype="float32")
KERNELS = ("qk_dequant_matmul", "pv_dequant_matmul", "flash_extend_qhist",
           "flash_extend_attention", "fused_decode_attention_wide",
           "fused_decode_attention")


def _engines(debug=False):
    jcfg, tcfg = j_tiny_config(**MODEL), tiny_config(**MODEL)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                         torch.float32)
    jeng = JEngine(cfg=jcfg, qcfg=JQuantConfig(**QUANT), params=jp,
                   max_seq_len=TMAX, batch_size=1, impl="jnp")
    jeng.cache_dtype = jnp.float32
    teng = Engine(cfg=tcfg, qcfg=QuantConfig(**QUANT), params=tp,
                  max_seq_len=TMAX, batch_size=1, device="cpu",
                  cache_dtype=torch.float32, debug=debug)
    return jeng, teng


@pytest.fixture
def routes(monkeypatch):
    """Lower SPLIT_MIN_HISTORY to 2 K windows and count the calls of
    each kernel wrapper the attention module reaches."""
    monkeypatch.setattr(TA, "SPLIT_MIN_HISTORY", 64)
    calls = collections.Counter()
    for name in KERNELS:
        fn = getattr(TA, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(TA, name, wrapped)
    return calls


def _prompt():
    toks = np.zeros((1, PAD + PROMPT), np.int64)
    toks[0, PAD:] = np.random.default_rng(7).integers(1, 256, PROMPT)
    return toks


def test_long_slice_greedy_matches_jax(routes):
    jeng, teng = _engines()
    toks = _prompt()
    want = np.asarray(jeng.generate(jnp.asarray(toks, jnp.int32), NEW,
                                    prefill_chunk_size=CHUNK,
                                    pad_lens=[PAD]))
    got = teng.generate(torch.from_numpy(toks), NEW,
                        prefill_chunk_size=CHUNK, pad_lens=[PAD])
    assert got.dtype == torch.int32 and got.shape == (1, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    # 7 chunks: histories 0, 32 take the full extend kernel, 64..192 the
    # qhist route; every decode step (history >= 224) the per-row kernel
    # over device counters
    n_chunks = (PAD + PROMPT) // CHUNK
    L = teng.cfg.num_layers
    assert routes["flash_extend_attention"] == 2 * L
    assert routes["flash_extend_qhist"] == (n_chunks - 2) * L
    assert routes["fused_decode_attention"] == (NEW - 1) * L
    assert routes["qk_dequant_matmul"] == 0
    assert routes["pv_dequant_matmul"] == 0
    assert routes["fused_decode_attention_wide"] == 0
    # debug=True: the same step run eagerly as a checked call
    routes.clear()
    dbg = _engines(debug=True)[1]
    got = dbg.generate(torch.from_numpy(toks), NEW,
                       prefill_chunk_size=CHUNK, pad_lens=[PAD])
    np.testing.assert_array_equal(got.numpy(), want)
    assert routes["fused_decode_attention"] == (NEW - 1) * L
    assert routes["qk_dequant_matmul"] == 0
    # host-int steps (decode_step, flushing as it goes): every step
    # through the split route, the same greedy tokens
    routes.clear()
    logits, caches = dbg.prefill_chunked(torch.from_numpy(toks), CHUNK,
                                         pad_lens=[PAD])
    out = [int(logits.argmax(-1))]
    for i in range(NEW - 1):
        logits, caches = dbg.decode_step(
            torch.tensor([[out[-1]]]), torch.tensor([[PROMPT + i]]), caches,
            pad_lens=[PAD], flush=True)
        out.append(int(logits.argmax(-1)))
    np.testing.assert_array_equal(np.asarray([out]), want)
    assert routes["flash_extend_attention"] == 2 * L
    assert routes["flash_extend_qhist"] == (n_chunks - 2) * L
    assert routes["qk_dequant_matmul"] == (NEW - 1) * L
    assert routes["pv_dequant_matmul"] == (NEW - 1) * L
    assert routes["fused_decode_attention_wide"] == 0
    assert routes["fused_decode_attention"] == 0
    # the run crossed K and V window flushes on the static schedule
    events = TE.flush_schedule(teng.qcfg, PAD + PROMPT, NEW - 1)
    assert events == JEngine._flush_schedule(jeng.qcfg, PAD + PROMPT,
                                             NEW - 1)
    assert any(k for k, _ in events.values())
    assert any(v for _, v in events.values())


def test_long_slice_teacher_forced_logits_match_jax(routes):
    jeng, teng = _engines()
    toks = _prompt()
    jtoks = jnp.asarray(toks, jnp.int32)
    stream = np.asarray(jeng.generate(jtoks, NEW, prefill_chunk_size=CHUNK,
                                      pad_lens=[PAD]))
    want, jc = jeng.prefill_chunked(jtoks, CHUNK, pad_lens=[PAD])
    got, tc = teng.prefill_chunked(torch.from_numpy(toks), CHUNK,
                                   pad_lens=[PAD])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # the left pad and the quantized counts after the prefill
    assert tc[0].seq_len == PAD + PROMPT == int(jc[0].seq_len)
    for n in ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win"):
        assert getattr(tc[0], n) == int(getattr(jc[0], n)), n
    jpad = jnp.asarray([PAD], jnp.int32)
    pos = PROMPT
    for i in range(NEW - 1):
        tok = stream[:, i:i + 1].copy()
        want, jc = jeng._decode(jeng.params, jnp.asarray(tok, jnp.int32),
                                jnp.asarray([[pos + i]], jnp.int32), jc,
                                jpad)
        got, tc = teng.decode_step(torch.from_numpy(tok),
                                   torch.tensor([[pos + i]]), tc,
                                   pad_lens=[PAD], flush=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=f"step {i}")
    assert routes["qk_dequant_matmul"] == (NEW - 1) * teng.cfg.num_layers
    assert routes["fused_decode_attention_wide"] == 0


def test_slice_flush_schedule_matches_jax():
    """The full-size slice's static schedule: 12,032 prompt tokens (a
    multiple of W = 32 and of the 128-token chunk) leave the K window
    empty and the V window full, so V flushes before decode step 0 and
    every 32 steps after, K from step 32 on — as the JAX engine has it."""
    from kivi_tpu.serving import engine as JE
    tq, jq = QuantConfig(**QUANT), JQuantConfig(**QUANT)
    T, steps = 12032, 63
    assert TE.phase_period(tq) == JE.phase_period(jq) == 32
    phase = TE.canonical_phase(tq, T)
    assert phase == JE.canonical_phase(jq, T)
    events = TE.flush_schedule(tq, phase, steps)
    assert events == JEngine._flush_schedule(jq, phase, steps)
    assert events == {0: (False, True), 32: (True, True)}


def test_split_rule_keeps_the_fused_paths():
    """The rule at full size: the engine main path (Llama-2 MHA, batch
    8: 256 decode blocks, 256 extend blocks of 128-token chunks) and the
    batcher (per-row device counters) keep the fused kernels; the long
    slice (batch 1, 8 KV heads, r = 4) splits once its history passes
    SPLIT_MIN_HISTORY."""
    assert TA.SPLIT_BLOCKS == 132
    assert 1024 <= TA.SPLIT_MIN_HISTORY <= 8192
    ext = lambda B, Hkv, r, T1: -(-r * T1 // TA.EXTEND_ROWS) * B * Hkv
    for nkq in (896, 4096, 16384):
        assert not TA.use_split(8 * 32, nkq)              # decode
        assert not TA.use_split(ext(8, 32, 1, 128), nkq)  # extend
        assert not TA.use_split(8 * 8, torch.full((8,), nkq))  # batcher
    assert TA.use_split(1 * 8, 12000)
    assert TA.use_split(ext(1, 8, 4, 128), 12000)
    assert not TA.use_split(1 * 8, TA.SPLIT_MIN_HISTORY - 1)
    assert TA.use_split(1 * 8, TA.SPLIT_MIN_HISTORY)


def test_slot_cache_keeps_the_per_row_kernel(routes, monkeypatch):
    """Per-row device counters never take the split route, even with the
    threshold at 0."""
    monkeypatch.setattr(TA, "SPLIT_MIN_HISTORY", 0)
    qcfg = QuantConfig(**QUANT)
    c = KC.init_slot_cache(2, 2, 64, TMAX, qcfg, dtype=torch.float32,
                           device="cpu")
    c.n_k_quant.fill_(64)
    c.n_v_quant.fill_(64)
    c.n_k_win.fill_(5)
    c.n_v_win.fill_(5)
    q = torch.randn(2, 8, 1, 64, generator=torch.Generator().manual_seed(0))
    out = TA.decode_attention(q, c, qcfg)
    assert torch.isfinite(out).all()
    assert routes["fused_decode_attention"] == 1
    assert routes["qk_dequant_matmul"] == routes["pv_dequant_matmul"] == 0
