"""The split algebra of the KIVI decode kernels (`csrc/kdec_split.cuh`,
rows 4 and 6) on the CPU: a plain-PyTorch model of the kernel's partition
-- partials (m, l, acc) per SPLIT-position split, K from the store below
n_k_quant and from k_win above it, V from the store below n_v_quant and
from v_win above it, merged in split order as the last block of each head
merges them -- held to the plain versions the kernels are held to on the
card, at fills around the split size and the boundary cases of the card
tests, and to the JAX package's Pallas `fused_decode_attention` (interpret
mode) at one fill.  Also the host-side split plan and workspace.

Tolerance: the model and the plain versions compute in f32 from the same
inputs, summed in another order: max|model - plain| <= 1e-6 * max|plain|.
Against the Pallas kernel (bf16 compute), 3e-2 as
tests/test_torch_attention.py holds the per-row plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import fused_decode as FR
from kivi_tpu_torch.kernels import fused_decode_wide as FW

torch.set_num_threads(2)

H, D, TMAX, W = 2, 64, 1024, 128
S = FW.SPLIT
NEG_INF = -1e30


def split_model(qg, c, counts, lo, *, gs, k_bits, v_bits, nsplit=None):
    """The kernel's partition in plain PyTorch: (B, H, r, D) f32.  counts
    (B, 3) host ints per row; nsplit None = split_plan of each row's
    n_k_quant + n_k_win (the host-int kernel), else that many splits
    (the per-row kernel's ceil(Tmax / SPLIT))."""
    B, Hk, r, d = qg.shape
    k_deq = Q.dequantize_k(c.k_codes, c.k_scale, c.k_mn, gs, k_bits)
    v_deq = Q.dequantize_v(c.v_codes, c.v_scale, c.v_mn, gs, v_bits)
    out = torch.zeros(qg.shape, dtype=torch.float32)
    for b in range(B):
        nkq, nkw, nvq = (int(x) for x in counts[b])
        end, lo_b = nkq + nkw, max(int(lo[b]), 0)
        # K and V of positions [0, end): store, then window rows
        kk = torch.cat([k_deq[b, :, :, :nkq].transpose(-1, -2),
                        c.k_win[b, :, :nkw].float()], dim=1)
        vv = torch.cat([v_deq[b, :, :nvq],
                        c.v_win[b, :, :end - nvq].float()], dim=1)
        q = qg[b].float()
        parts = []
        for s in range(FW.split_plan(end) if nsplit is None else nsplit):
            a, e = max(s * S, lo_b), min(s * S + S, end)
            if a >= e:                       # the neutral partial
                parts.append((torch.full((Hk, r), NEG_INF),
                              torch.zeros(Hk, r), None))
                continue
            logits = torch.einsum("hrd,htd->hrt", q, kk[:, a:e]) / math.sqrt(d)
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("hrt,htd->hrd", p, vv[:, a:e])))
        # the merge, in split order
        live = [x for x in parts if x[2] is not None]
        if not live:
            continue
        M = torch.stack([m for m, _, _ in live]).amax(0)
        L = torch.zeros(Hk, r)
        A = torch.zeros(Hk, r, d)
        for m, l, acc in live:
            f = torch.exp(m - M)
            L = L + l * f
            A = A + acc * f[..., None]
        out[b] = A / L[..., None]
    return out


def _cache(fill, bits, vf, batch=3, seed=0):
    """A port cache on the CPU holding `fill` tokens (the last appended by
    decode_append), f32 scales."""
    g = torch.Generator().manual_seed(seed)
    qcfg = QuantConfig(bits, bits, 32, W, v_flush=vf,
                       scale_dtype="float32")
    c = KC.init_layer_cache(batch, H, D, TMAX, qcfg, device="cpu")
    n = lambda t: torch.randn((batch, H, t, D), generator=g)  # noqa: E731
    if fill > 1:
        KC.prefill_ingest(c, n(fill - 1), n(fill - 1), qcfg)
    KC.decode_append(c, n(1), n(1), qcfg)
    return c


def _span(bits, seed=1):
    """A hand-set state whose window spans the first two splits and whose
    first split straddles n_v_quant < n_k_quant: n_k_quant 200, n_k_win
    100, n_v_quant 180 (store contents random, quantized by core.quant)."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    k = Q.quantize_k_block(n(3, H, D, TMAX), 32, bits)
    v = Q.quantize_v_block(n(3, H, TMAX, D), 32, bits)
    return KiviLayerCache(*k, *v, n(3, H, W, D).bfloat16(),
                          n(3, H, W, D).bfloat16(), n_k_quant=200,
                          n_k_win=100, n_v_quant=180, n_v_win=120)


def _check(got, want, what):
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), (what, err)


# (fill, bits, v_flush, lower bound, r): fills around the split size, the
# main path's 1081, 2S + 57 and Tmax; n_v_quant < n_k_quant; pads and
# windows that kill whole splits
CASES = [(fill, 2, 128, None, 1)
         for fill in (1, S - 1, S, S + 1, 2 * S + 57, TMAX)]
CASES += [(700, 4, 32, None, 4), (2 * S + 57, 8, 32, "pad", 2),
          ("span", 2, 128, None, 1), ("span", 4, 128, "pad", 4),
          (TMAX, 2, 32, "swa", 8), (S + 1, 8, 128, "pad", 1)]


def _lo(mask, seq_len):
    if mask == "pad":     # row 1 loses whole splits, row 2 everything
        return torch.tensor([37, min(S + 10, seq_len - 1), seq_len])
    if mask == "swa":
        return torch.full((3,), max(seq_len - 300, 0))
    return torch.zeros(3, dtype=torch.int64)


@pytest.mark.parametrize("fill,bits,vf,mask,r", CASES)
def test_split_model_matches_plain(fill, bits, vf, mask, r):
    """The partition, merged in order, is the wide kernel's plain function
    (rows that see something) and the per-row kernel's (every row: an
    empty row gives zeros), at the host-int and the per-row split plans."""
    c = _span(bits) if fill == "span" else _cache(fill, bits, vf)
    qg = torch.randn((3, H, r, D),
                     generator=torch.Generator().manual_seed(r)).bfloat16()
    lo = _lo(mask, c.seq_len)
    counts = [(c.n_k_quant, c.n_k_win, c.n_v_quant)] * 3
    arrays = (qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
              c.v_mn, c.k_win, c.v_win)
    kw = dict(group_size=32, k_bits=bits, v_bits=bits)
    got = split_model(qg, c, counts, lo, gs=32, k_bits=bits, v_bits=bits)
    want = FW.fused_decode_attention_wide_plain(
        *arrays, c.n_k_quant, c.n_k_win, c.n_v_quant, lo=lo, **kw)
    live = lo < c.seq_len
    what = f"fill={fill} bits={bits} vf={vf} {mask} r={r}"
    _check(got[live], want[live], what)
    assert (got[~live] == 0).all()
    rows = split_model(qg, c, counts, lo, gs=32, k_bits=bits, v_bits=bits,
                       nsplit=-(-TMAX // S))
    assert torch.equal(rows, got)
    _check(rows, FR.fused_decode_attention_plain(
        *arrays, torch.tensor(counts), lo=lo, **kw), what + " per row")


def test_split_model_per_row_fills():
    """Per-row counters (a slot cache at divergent fills, one empty slot)
    at the per-row kernel's plan, against its plain version."""
    qcfg = QuantConfig(4, 4, 32, W, v_flush=32, scale_dtype="float32")
    fills = (1, S - 1, 700, 0, TMAX)
    slots = KC.init_slot_cache(len(fills), H, D, TMAX, qcfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    for s, fill in enumerate(fills):
        if fill:
            one = _cache(fill, 4, 32, batch=1, seed=s)
            KC.write_slot(slots, s, one)
    counts = torch.stack([slots.n_k_quant, slots.n_k_win, slots.n_v_quant],
                         dim=1)
    qg = torch.randn((len(fills), H, 2, D), generator=g).bfloat16()
    lo = torch.tensor([0, 100, 37, 0, 900])
    got = split_model(qg, slots, counts.tolist(), lo, gs=32, k_bits=4,
                      v_bits=4, nsplit=-(-TMAX // S))
    want = FR.fused_decode_attention_plain(
        qg, slots.k_codes, slots.k_scale, slots.k_mn, slots.v_codes,
        slots.v_scale, slots.v_mn, slots.k_win, slots.v_win, counts,
        group_size=32, k_bits=4, v_bits=4, lo=lo)
    _check(got, want, "per-row fills")
    assert (got[fills.index(0)] == 0).all()


def test_split_model_matches_pallas_kernel():
    """The partition against the JAX package's Pallas
    fused_decode_attention (interpret mode), n_v_quant < n_k_quant, three
    splits, a left pad."""
    from kivi_tpu.kernels.fused_decode import \
        fused_decode_attention as j_fused
    kw = dict(k_bits=2, v_bits=2, group_size=32, residual_length=W,
              v_flush=32)
    jq = JQuantConfig(**kw)
    rng = np.random.default_rng(11)
    n = lambda *s: jnp.asarray(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    jc = JC.init_layer_cache(2, H, D, TMAX, jq)
    jc = JC.prefill_ingest(jc, n(2, H, 600, D), n(2, H, 600, D), jq)
    jc = JC.decode_append(jc, n(2, H, 1, D), n(2, H, 1, D), jq)
    c = KiviLayerCache(
        **{f: torch.from_numpy(np.asarray(getattr(jc, f)).view(np.int32)
                               .copy())
           if np.asarray(getattr(jc, f)).dtype == np.uint32 else
           torch.from_numpy(np.asarray(getattr(jc, f)).astype(np.float32))
           .to(torch.bfloat16)
           for f in ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale",
                     "v_mn", "k_win", "v_win")},
        n_k_quant=int(jc.n_k_quant), n_k_win=int(jc.n_k_win),
        n_v_quant=int(jc.n_v_quant), n_v_win=int(jc.n_v_win))
    assert c.n_v_quant < c.n_k_quant and FW.split_plan(c.seq_len) == 3
    qg = rng.standard_normal((2, H, 2, D)).astype(np.float32)
    pad = np.array([0, 37], np.int32)
    counts = [(c.n_k_quant, c.n_k_win, c.n_v_quant)] * 2
    got = split_model(torch.from_numpy(qg).bfloat16(), c, counts,
                      torch.from_numpy(pad), gs=32, k_bits=2, v_bits=2)
    want = j_fused(jnp.asarray(qg).astype(jnp.bfloat16), jc.k_codes,
                   jc.k_scale, jc.k_mn, jc.v_codes, jc.v_scale, jc.v_mn,
                   jc.k_win, jc.v_win, jc.n_k_quant, jc.n_k_win,
                   jc.n_v_quant, group_size=32, k_bits=2, v_bits=2,
                   pad_len=jnp.asarray(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("n_end,want", [(0, 1), (1, 1), (S - 1, 1), (S, 1),
                                        (S + 1, 2), (1081, 5),
                                        (32768, 128)])
def test_split_plan(n_end, want):
    """Splits of the host-int kernel: ceil(n_end / SPLIT), at least one,
    from position 0 (the lower bound lives on the device)."""
    assert FW.split_plan(n_end) == want


def test_workspace_is_cached_and_sized():
    """One workspace per device and shape: partials for B*H*nsplit*r rows
    of D, (m, l) pairs, and B*H zero tickets; reused by every call."""
    acc, ml, tickets = _build.workspace(torch.device("cpu"), 6, 5, 4, 64)
    assert acc.shape == (6 * 5 * 4 * 64,) and ml.shape == (2 * 6 * 5 * 4,)
    assert acc.dtype == ml.dtype == torch.float32
    assert tickets.dtype == torch.int32 and (tickets == 0).all()
    assert tickets.shape == (6,)
    assert _build.workspace(torch.device("cpu"), 6, 5, 4, 64)[0] is acc
