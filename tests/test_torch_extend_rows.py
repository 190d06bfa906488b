"""Row 3's per-row entry on the CPU: `flash_extend_attention_rows_plain`
(kivi_tpu_torch/kernels/flash_extend.py), the extend attention over
counters given per batch row, as the speculative verify runs over slot
caches.

  * row by row against the host-int plain version at that row's
    counters (rtol 2e-5 at f32: the two gather the window's values in
    another order);
  * against the JAX package's `extend_attention(impl="jnp")` vmapped
    over batch-1 caches, each with its own counters (the JAX speculative
    batcher's verify, kivi_tpu/serving/spec_batcher.py:204-219), at
    f32 (atol 2e-5);
  * `core.attention.extend_attention` sends per-row device counters to
    the per-row entry and host ints to the host-int one.

Caches are built by the JAX package (prefill_ingest, then two
decode_appends) from seeded numpy inputs and copied into the
port's layout, so both read the same bits.  Rows sit at different
fills and window phases, one row is empty, some are left-padded; bits
2/4/8, GQA r = 2, T1 = 5 and 9 (k + 1 of the speculative paths) and a
sliding window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.core.attention import extend_attention as j_extend
from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import attention as TA
from kivi_tpu_torch.kernels import flash_extend as FE

torch.set_num_threads(2)

H, D, TMAX, W = 2, 32, 512, 32
FIELDS = ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
          "k_win", "v_win")
COUNTERS = ("n_k_quant", "n_k_win", "n_v_quant", "n_v_win")
FILLS = (1, 45, 64, 100, 133, 0)        # tokens per slot (0: empty)


def _kw(bits, vf):
    """vf 16 takes group size 16 (v_flush is a multiple of the group)."""
    return dict(k_bits=bits, v_bits=bits, group_size=min(32, vf),
                residual_length=W, v_flush=vf, scale_dtype="float32")


def _slots(bits, vf, seed):
    """One batch-1 JAX cache per slot: FILLS[s] - 2 tokens ingested, then
    two decode appends (so windows sit mid-phase, V behind K when
    vf < W).  The JAX quantizer runs eagerly (ROADMAP Queue 3)."""
    jq = JQuantConfig(**_kw(bits, vf))
    rng = np.random.default_rng(seed)
    n = lambda t: jnp.asarray(rng.standard_normal((1, H, t, D)),
                              jnp.float32)
    out = []
    with jax.disable_jit():
        for fill in FILLS:
            c = JC.init_layer_cache(1, H, D, TMAX, jq, dtype=jnp.float32)
            if fill > 2:
                c = JC.prefill_ingest(c, n(fill - 2), n(fill - 2), jq)
            for _ in range(min(fill, 2)):
                c = JC.decode_append(c, n(1), n(1), jq)
            out.append(c)
    return out


def _port(jcs) -> KiviLayerCache:
    f = {}
    for name in FIELDS:
        a = np.concatenate([np.asarray(getattr(c, name)) for c in jcs])
        f[name] = torch.from_numpy(a.view(np.int32).copy() if a.dtype ==
                                   np.uint32 else a.copy())
    cnt = {name: torch.tensor([int(getattr(c, name)) for c in jcs],
                              dtype=torch.int32) for name in COUNTERS}
    return KiviLayerCache(**f, **cnt)


CASES = [(2, 32, 1, 5, False, 0), (2, 16, 1, 9, True, 0),
         (4, 32, 2, 9, True, 0), (8, 16, 2, 5, False, 0),
         (2, 32, 2, 9, True, 40)]


@pytest.mark.parametrize("bits,vf,r,t1,padded,sw", CASES)
def test_rows_plain_matches_host_int_and_vmapped_jax(bits, vf, r, t1, padded,
                                                     sw):
    jcs = _slots(bits, vf, seed=bits * 10 + t1)
    c = _port(jcs)
    S = len(FILLS)
    rng = np.random.default_rng(t1 + r)
    q = rng.standard_normal((S, H * r, t1, D)).astype(np.float32)
    kn = rng.standard_normal((S, H, t1, D)).astype(np.float32)
    vn = rng.standard_normal((S, H, t1, D)).astype(np.float32)
    pad = np.array([0, 3, 0, 30, 7, 0][:S]) if padded else None
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    arrays = (torch.from_numpy(q).reshape(S, H, r * t1, D), c.k_codes,
              c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn, c.k_win,
              c.v_win, torch.from_numpy(kn), torch.from_numpy(vn))
    kw = dict(group_size=min(32, vf), k_bits=bits, v_bits=bits, t1=t1,
              sliding_window=sw,
              pad_len=None if pad is None else torch.from_numpy(pad))
    got = FE.flash_extend_attention_rows_plain(*arrays, counts, **kw)

    # row by row: the host-int plain version at the row's counters
    for s in range(S):
        one = FE.flash_extend_attention_plain(
            *(a[s:s + 1] for a in arrays), *(int(x) for x in counts[s]),
            **dict(kw, pad_len=None if pad is None
                   else torch.from_numpy(pad[s:s + 1])))
        torch.testing.assert_close(got[s:s + 1], one, rtol=2e-5, atol=2e-6,
                                   msg=f"row {s} counters {counts[s]}")

    # the JAX extend attention vmapped over the slots' own caches
    jq = JQuantConfig(**_kw(bits, vf))
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jcs)

    def one_slot(q1, k1, v1, cache1, p1):
        return j_extend(q1[None], k1[None], v1[None], cache1, jq,
                        impl="jnp", sliding_window=sw or None,
                        pad_len=None if p1 is None else p1[None])[0]

    with jax.default_matmul_precision("highest"):
        want = jax.vmap(one_slot, in_axes=(0, 0, 0, 0, None if pad is None
                                           else 0))(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jstack,
            None if pad is None else jnp.asarray(pad, jnp.int32))
    np.testing.assert_allclose(got.reshape(S, H * r, t1, D).numpy(),
                               np.asarray(want), atol=2e-5, rtol=0)


def test_extend_attention_routes_per_row_counters(monkeypatch):
    """Device counters go to the per-row entry, host ints to the host-int
    one (use_split declines tensor counters)."""
    jcs = _slots(2, 32, seed=1)
    calls = []
    for name in ("flash_extend_attention", "flash_extend_attention_rows"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    qcfg = QuantConfig(**_kw(2, 32))
    rows = _port(jcs)
    S, t1 = len(FILLS), 5
    x = torch.randn(S, H, t1, D)
    per_row = TA.extend_attention(x, x, x, rows, qcfg)
    assert calls == ["flash_extend_attention_rows"]
    # one row through the host-int route gives that row's answer
    s = FILLS.index(100)
    one = _port([jcs[s]])
    for n in COUNTERS:
        setattr(one, n, int(getattr(one, n)[0]))
    host = TA.extend_attention(x[s:s + 1], x[s:s + 1], x[s:s + 1], one, qcfg)
    assert calls[-1] == "flash_extend_attention"
    torch.testing.assert_close(per_row[s:s + 1], host, rtol=2e-5, atol=2e-6)


def test_rows_entry_on_cpu_takes_the_plain_version():
    """On a CPU tensor the wrapper is its plain version (no counter
    checks, no kernel)."""
    jcs = _slots(4, 32, seed=2)
    c = _port(jcs)
    S, t1 = len(FILLS), 9
    q = torch.randn(S, H, t1, D)
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win, q, q, counts)
    kw = dict(group_size=32, k_bits=4, v_bits=4, t1=t1)
    torch.testing.assert_close(FE.flash_extend_attention_rows(*args, **kw),
                               FE.flash_extend_attention_rows_plain(*args,
                                                                    **kw),
                               rtol=0, atol=0)
