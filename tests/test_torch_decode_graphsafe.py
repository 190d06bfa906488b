"""The decode steps a CUDA graph captures, run eagerly on the CPU: the
engine's step over device counters (`Engine._decode_body`, what
`Engine.decode` replays on the card) and the batcher's
(`ContinuousBatcher._decode_all` under `_decode_for(fb)`), against the
JAX package's compiled decode (`Engine._decode_scan`, the batcher's
`_decode_for`) and against the port's host-int steps
(`Engine.decode_step`, which checks the windows before each append):

  * greedy tokens equal JAX `Engine.generate`'s (KIVI-2 and KIVI-4, with
    and without left pads, across K and V flushes; the fp16 cache);
  * the caches end bit-equal to host-int `decode_step`'s, counters included;
  * the batcher's per-slot `fill` and its sequence of fill bounds equal
    the JAX batcher's for the same requests;
  * no rebinding: every tensor of the engine's and the batcher's step
    state keeps its storage across three steps, one of them a flush
    step (a replay reads and writes those addresses only).

Tolerance: tokens and cache bytes equal.  Both packages run the same
f32 weights over f32 caches (tests/test_torch_engine.py).
"""

import copy
import dataclasses

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
from kivi_tpu_torch.serving import engine as TE
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import Engine

torch.set_num_threads(2)

B, TMAX, PROMPT, NEW = 2, 384, 200, 80


@pytest.fixture(autouse=True)
def _exact_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _params():
    jp = JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", torch.float32)


def _kw(bits, vf=32, W=128):
    return dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=W,
                v_flush=vf, scale_dtype="float32")


def _engines(bits, vf=32):
    jp, tp = _params()
    jeng = JEngine(cfg=j_tiny_config(), qcfg=JQuantConfig(**_kw(bits, vf)),
                   params=jp, max_seq_len=TMAX, batch_size=B, impl="jnp")
    jeng.cache_dtype = jnp.float32
    teng = Engine(tiny_config(), QuantConfig(**_kw(bits, vf)), tp,
                  max_seq_len=TMAX, batch_size=B, device="cpu",
                  cache_dtype=torch.float32)
    return jeng, teng


@pytest.mark.parametrize("bits,vf,pad,chunk", [
    (2, 128, None, 128), (2, 32, (0, 37), 128), (4, 32, (0, 37), None),
    (4, 128, None, None), (16, 32, None, None), (16, 32, (0, 37), 128)])
def test_device_counter_decode_matches_jax_generate(monkeypatch, bits, vf,
                                                    pad, chunk):
    """The port's non-debug decode on the CPU is the captured body, run
    eagerly `steps` times (counted here), over device counters."""
    jeng, teng = _engines(bits, vf)
    calls = []
    body = teng._decode_body
    monkeypatch.setattr(teng, "_decode_body",
                        lambda *a: calls.append(1) or body(*a))
    toks = np.random.default_rng(bits + vf).integers(0, 256, (B, PROMPT))
    want = np.asarray(jeng.generate(jnp.asarray(toks, jnp.int32), NEW,
                                    prefill_chunk_size=chunk, pad_lens=pad))
    got = teng.generate(torch.from_numpy(toks), NEW,
                        prefill_chunk_size=chunk, pad_lens=pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(calls) == NEW - 1
    # the counters are host ints again after the decode
    c = teng._caches[0]
    assert isinstance(c.seq_len, int) and c.seq_len == PROMPT + NEW - 1


def _cache_state(caches):
    return [{f.name: (getattr(c, f.name).clone()
                      if isinstance(getattr(c, f.name), torch.Tensor)
                      else getattr(c, f.name))
             for f in dataclasses.fields(c)} for c in caches]


@pytest.mark.parametrize("bits,pad", [(2, (0, 37)), (4, None), (16, (3, 0))])
def test_device_counter_caches_equal_host_int_loop(bits, pad):
    """One prefill, decoded twice from the same state: by the replayed
    body (device counters, flushes on the static schedule) and by greedy
    host-int steps (`decode_step`, flushing full windows as it goes).
    Tokens equal; every cache byte and counter equal at the end."""
    _, teng = _engines(bits)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (B, PROMPT)))
    first, caches = teng.prefill(toks, pad_lens=pad)
    caches2 = copy.deepcopy(caches)
    pos = torch.full((B, 1), PROMPT) - (0 if pad is None
                                        else torch.tensor(pad)[:, None])
    got, caches = teng.decode(first, pos, caches, steps=NEW,
                              prompt_len=PROMPT, pad_lens=pad)
    tok, want = first, []
    for i in range(NEW):
        logits, caches2 = teng.decode_step(tok, pos + i, caches2,
                                           pad_lens=pad, flush=True)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        want.append(tok)
    assert torch.equal(got, torch.cat(want, dim=1))
    for a, b in zip(_cache_state(caches), _cache_state(caches2)):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            else:
                assert type(a[k]) is int and a[k] == b[k], k


def _spy_bounds(bat, log):
    orig = bat._decode_for

    def spy(fb):
        log.append(fb)
        return orig(fb)

    bat._decode_for = spy


def test_batcher_fill_and_bounds_match_jax():
    """Greedy requests through 2 slots of a 1024-token cache: short
    prompts (64-token bucket) keep the bound at 512, a 300-token prompt
    (512 bucket) raises it to 1024 while it is active."""
    jp, tp = _params()
    kw = _kw(2, W=32)
    jb = JBatcher(j_tiny_config(), JQuantConfig(**kw), jp, num_slots=2,
                  max_seq_len=1024, prompt_buckets=(64, 512))
    jb.caches = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jb.caches)
    tb = ContinuousBatcher(tiny_config(), QuantConfig(**kw), tp,
                           num_slots=2, max_seq_len=1024, device="cpu",
                           prompt_buckets=(64, 512),
                           cache_dtype=torch.float32)
    rng = np.random.RandomState(3)
    specs = [dict(prompt=[int(t) for t in rng.randint(1, 256, size=n)],
                  max_new_tokens=m)
             for n, m in ((20, 12), (300, 20), (45, 30), (33, 8))]
    jlog, tlog = [], []
    _spy_bounds(jb, jlog)
    _spy_bounds(tb, tlog)
    want = jb.run([JRequest(uid=i, **s) for i, s in enumerate(specs)])
    got = tb.run([Request(uid=i, **s) for i, s in enumerate(specs)])
    assert {u: r.tokens for u, r in got.items()} == \
        {u: r.tokens for u, r in want.items()}
    assert tlog == jlog and set(tlog) == {512, 1024}
    np.testing.assert_array_equal(tb.fill, jb.fill)


def _ptrs(named):
    return {k: t.data_ptr() for k, t in named.items()}


def _named(obj, fields, caches):
    """The step state's tensors by name, the caches' included."""
    named = {n: getattr(obj, n) for n in fields
             if isinstance(getattr(obj, n), torch.Tensor)}
    for i, c in enumerate(caches):
        for f in dataclasses.fields(c):
            named[f"caches[{i}].{f.name}"] = getattr(c, f.name)
    return named


@pytest.mark.parametrize("bits", [2, 16])
def test_engine_step_state_keeps_storage(bits):
    """Three plain steps of the engine's body with a scheduled flush
    between the first two (a 223-token prompt leaves 95 in the K window
    and 127 in the V window: V flushes before step 1)."""
    _, teng = _engines(bits)
    prompt = 223
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (B, prompt)))
    first, caches = teng.prefill(toks, pad_lens=(0, 5))
    pos = torch.full((B, 1), prompt) - torch.tensor([[0], [5]])
    st = teng._decode_begin(first, pos, caches, (0, 5), None)
    events = (TE.flush_schedule(teng.qcfg, TE.canonical_phase(
        teng.qcfg, prompt), 3) if teng.qcfg.quantize_kv else {})
    assert bits == 16 or 1 in events
    def state():
        return _named(st, [f.name for f in dataclasses.fields(st)],
                      st.caches)

    named = state()
    assert any(k.endswith("n_k_quant") or k.endswith("length")
               for k in named)
    before = _ptrs(named)
    fb = TE.fill_bound(prompt, 3)
    for i in range(3):
        if i in events:
            from kivi_tpu_torch.models import modeling
            modeling.flush_caches(caches, teng.qcfg, k=events[i][0],
                                  v=events[i][1])
        teng._decode_body(st, fb, True, 0.0, 0, 1.0, 1.0, None)
        assert _ptrs(state()) == before, i
    assert st.step.item() == 3
    toks3 = teng._decode_end(st, 3)
    assert toks3.shape == (B, 3) and caches[0].seq_len == prompt + 3


@pytest.mark.parametrize("bits", [2, 16])
def test_batcher_step_state_keeps_storage(bits):
    """Three steps of the batcher's body over two admitted requests, a
    sampled one among them; with the 32-token window the bucketed
    admission leaves a full V window, flushed in the first step."""
    _, tp = _params()
    bat = ContinuousBatcher(tiny_config(), QuantConfig(**_kw(bits, W=32)),
                            tp, num_slots=3, max_seq_len=256, device="cpu",
                            prompt_buckets=(32, 64),
                            cache_dtype=torch.float32)
    bat.submit(Request(uid=0, prompt=list(range(1, 21)), max_new_tokens=9))
    bat.submit(Request(uid=1, prompt=list(range(5, 45)), max_new_tokens=9,
                       temperature=0.7, repetition_penalty=1.3))
    bat._admit()

    def state():
        return _named(bat, ("cur_tok", "pos", "pad_dev", "act_dev",
                            "temp_dev", "topk_dev", "topp_dev", "pen_dev",
                            "seen_dev", "last_logits", "nxt"), bat.caches)

    before = _ptrs(state())
    nvq0 = [int(x) for x in getattr(bat.caches[0],
                                    "n_v_quant" if bits != 16 else "length")]
    for i in range(3):
        out = bat._decode_for(512)()
        assert out is bat.nxt
        assert _ptrs(state()) == before, i
    nvq = [int(x) for x in getattr(bat.caches[0],
                                   "n_v_quant" if bits != 16 else "length")]
    if bits != 16:
        assert nvq[0] > nvq0[0]          # the first step flushed
    assert bat.pos[:2, 0].tolist() == [20 + 3, 40 + 3]
