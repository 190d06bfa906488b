"""The split algebra of the split decode kernels (`csrc/qk_pv.cu`, rows 7
and 8) on the CPU: a plain-PyTorch model of the kernels' partition held
to the plain versions the kernels are held to on the card.

  * QK per SPLIT-position split: a split at or past n_quant is NEG_INF;
    in a live split each live group's K scale is folded into the query
    rows and q . mn kept apart (the kernel's FOLD form); positions >=
    n_quant NEG_INF.
  * PV per live split: p times the V scale per (group, position, row),
    the sum of p times the V min per (group, row) apart, the partials
    merged in split order as the last block of each head merges them.

At n_quant around the split size and the group size (0, 1, 255, 256,
257, 5017, a flushed cache's count, T), bits 2/4/8 and r 1/4/8; at the
edges of the kernels' contract (group sizes 1 to 128, D not a multiple
of 8, T a multiple of 4 only); one case against the JAX package's
Pallas kernels in interpret mode.  Also the host-side split plan and the
workspace PV writes its partials into.

Tolerances.  The models compute in f64, so they hold the partition's
algebra and not the kernels' f32 rounding (the folded forms set q . mn
and p . mn, each larger than the result, apart), which the card holds
at chip_smoke.py's ATT_RTOL.  QK (sums over D): max|model - plain| <=
1e-6 * max|plain|.  PV: the model against the plain formula evaluated
in f64 at 1e-6 * max|plain|; and against the f32 plain version at 1e-6
of the largest sum_t |p_t| |v_td|, the scale of an f32 dot product's
rounding (a softmax's nearly even p over thousands of positions
averages the values down far below its terms, and the f32 sum then
misses the exact value by more than 1e-6 of max|plain|).  Against the
Pallas kernels at compute_dtype=float32: rtol 2e-5, atol 2e-4
(tests/test_torch_qk_pv.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.kernels import pv_dequant_matmul as j_pv
from kivi_tpu.kernels import qk_dequant_matmul as j_qk
from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import _build
from kivi_tpu_torch.kernels import qk_pv as QP

torch.set_num_threads(2)

B, H, D, GS = 1, 2, 64, 32
T = 5280            # 20 whole splits and a partial one
S = QP.SPLIT
NEG_INF = -1e30
# around the split and group sizes; 4992 a flushed cache's count (whole
# groups); 5017 ends inside a group and inside a split
NQ = [0, 1, S - 1, S, S + 1, 5017, 4992, T]


def qk_model(qg, k_codes, k_scale, k_mn, gs, bits, nq):
    """The QK kernel's partition: (B, H, r, T) f32, computed in f64."""
    t = k_codes.shape[-1]
    c = Q.unpack_codes(k_codes, bits, axis=-2).double()   # (B, H, D, T)
    s, mn, q = k_scale.double(), k_mn.double(), qg.double()
    out = torch.full(qg.shape[:3] + (t,), NEG_INF, dtype=torch.float64)
    for s0 in range(0, t, S):
        hi = min(s0 + S, nq)        # a dead split keeps NEG_INF
        for a in range(s0, hi, gs):  # the split's live groups
            g, e = a // gs, min(a + gs, hi)
            sg, mg = s[:, :, g, None, :], mn[:, :, g, None, :]
            out[..., a:e] = (torch.einsum("bhrd,bhdt->bhrt", q * sg,
                                          c[..., a:e])
                             + (q * mg).sum(-1, keepdim=True))
    return out.float()


def pv_model(p, v_codes, v_scale, v_mn, gs, bits, nq):
    """The PV kernel's partition: (B, H, r, D) f64."""
    c = Q.unpack_codes(v_codes.transpose(-1, -2), bits, axis=-1).double()
    d = c.shape[-1]
    s, mn = v_scale.double(), v_mn.double()              # (B, H, D/gs, T)
    f64 = dict(dtype=torch.float64)
    parts = []
    for sp in range(QP.split_plan(nq)):
        s0, hi = sp * S, min(sp * S + S, nq)
        if hi <= s0:                 # n_quant 0: the one split is zeros
            break
        pp = p[..., s0:hi].double()
        acc = torch.zeros(p.shape[:3] + (d,), **f64)
        for g in range(d // gs):
            ps = pp * s[:, :, g, None, s0:hi]            # p times the scale
            pm = (pp * mn[:, :, g, None, s0:hi]).sum(-1, keepdim=True)
            acc[..., g * gs:(g + 1) * gs] = torch.einsum(
                "bhrt,bhtd->bhrd", ps, c[:, :, s0:hi, g * gs:(g + 1) * gs]) + pm
        parts.append(acc)
    out = torch.zeros(p.shape[:3] + (d,), **f64)
    for acc in parts:                # the merge, in split order
        out = out + acc
    return out


def pv_plain64(p, v_codes, v_scale, v_mn, gs, bits, nq):
    """pv_dequant_matmul_plain's formula evaluated in f64."""
    c = Q.unpack_codes(v_codes[..., :nq].transpose(-1, -2), bits,
                       axis=-1).double()                  # (B, H, nq, D)
    grp = lambda x: x[..., :nq].double().transpose(  # noqa: E731
        -1, -2).repeat_interleave(gs, dim=-1)
    return torch.einsum("bhrt,bhtd->bhrd", p[..., :nq].double(),
                        c * grp(v_scale) + grp(v_mn))


def _check(got, want, what, scale=None):
    """max|got - want| <= 1e-6 * scale (default max|want|)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item() if scale is None else scale
    assert err <= 1e-6 * scale, (what, err, scale)


def _check_pv(store, p, gs, bits, nq, what):
    """pv_model against the plain formula in f64 at 1e-6 * max|plain|,
    and against the f32 plain version at 1e-6 of _pv_scale."""
    got = pv_model(p, *store, gs, bits, nq)
    want = QP.pv_dequant_matmul_plain(p, *store, gs, bits, n_quant=nq)
    if nq == 0:
        assert (got == 0).all() and (want == 0).all()
        return
    _check(got, pv_plain64(p, *store, gs, bits, nq), what + " (f64)")
    _check(got.float(), want, what, _pv_scale(p, *store, gs, bits, nq))


def _pv_scale(p, v_codes, v_scale, v_mn, gs, bits, nq):
    """max over (row, channel) of sum_t |p_t| |v_td|, t < nq."""
    v = Q.dequantize_v(v_codes[..., :nq], v_scale[..., :nq], v_mn[..., :nq],
                       gs, bits)
    return torch.einsum("bhrt,bhtd->bhrd", p[..., :nq].abs().double(),
                        v.abs().double()).max().item()


@functools.lru_cache(maxsize=None)
def _store(bits, key, d=D, t=T, scale_dtype=torch.float32):
    """Codes, scales and minima of a K (key=True) or V store quantized
    from N(0, 1)."""
    g = torch.Generator().manual_seed(bits + 10 * key + d)
    if key:
        codes, s, mn = Q.quantize_k_block(
            torch.randn((B, H, d, t), generator=g), GS, bits)
    else:
        codes, s, mn = Q.quantize_v_block(
            torch.randn((B, H, t, d), generator=g), GS, bits)
    return (codes, s.to(scale_dtype).contiguous(),
            mn.to(scale_dtype).contiguous())


def _p(r, nq, t=T):
    """A softmax over the first nq positions, exactly zero past them."""
    x = torch.randn((B, H, r, t), generator=torch.Generator().manual_seed(r))
    x[..., nq:] = float("-inf")
    return torch.softmax(x, dim=-1).nan_to_num(0.0)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("nq", NQ)
def test_qk_model_matches_plain(bits, r, nq):
    """QK by split in the FOLD form: the plain version at
    every live position, NEG_INF exactly at and past n_quant."""
    store = _store(bits, True)
    qg = torch.randn((B, H, r, D), generator=torch.Generator().manual_seed(
        r)).bfloat16()
    got = qk_model(qg, *store, GS, bits, nq)
    want = QP.qk_dequant_matmul_plain(qg, *store, GS, bits, n_quant=nq)
    assert (got[..., nq:] == NEG_INF).all()
    if nq:
        _check(got[..., :nq], want[..., :nq], f"qk bits={bits} r={r} nq={nq}")


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("nq", NQ)
def test_pv_model_matches_plain(bits, r, nq):
    """PV partials per live split with p times the scale folded and the
    min term apart, merged in order: the plain version."""
    _check_pv(_store(bits, False), _p(r, nq), GS, bits, nq,
              f"pv bits={bits} r={r} nq={nq}")


@pytest.mark.parametrize("nq", [S + 1, 5017])
def test_qk_model_d128_bf16_scales(nq):
    """QK at D = 128 and bf16 scales (the long slice's store)."""
    store = _store(2, True, d=128, scale_dtype=torch.bfloat16)
    qg = torch.randn((B, H, 4, 128),
                     generator=torch.Generator().manual_seed(3)).bfloat16()
    got = qk_model(qg, *store, GS, 2, nq)
    want = QP.qk_dequant_matmul_plain(qg, *store, GS, 2, n_quant=nq)
    assert (got[..., nq:] == NEG_INF).all()
    _check(got[..., :nq], want[..., :nq], f"d=128 nq={nq}")


def test_pv_model_d128_bf16_scales():
    """PV at D = 128 and bf16 scales: 4 groups, 2 position phases."""
    store = _store(2, False, d=128, scale_dtype=torch.bfloat16)
    _check_pv(store, _p(4, 5017), GS, 2, 5017, "pv d=128 bf16")


# (bits, D, group size, scale dtype, T) at the edges of the CUDA kernels'
# contract: group sizes 1 and 2 (a thread's position or channel pair
# spans two groups), 4 and 128; D not a multiple of 8; T a multiple of 4
# and not of 8
EDGES = [(8, 4, 4, torch.bfloat16, 516), (8, 12, 2, torch.float32, 1000),
         (2, 32, 1, torch.bfloat16, 1028), (4, 24, 8, torch.bfloat16, 776),
         (2, 128, 128, torch.float32, 1024)]


@pytest.mark.parametrize("bits,d,gs,sdt,t", EDGES)
@pytest.mark.parametrize("nq", [1, S + 3, "T-1"])
def test_models_at_contract_edges(bits, d, gs, sdt, t, nq):
    """Both models at the contract's edges, r = 2, against the plain
    versions."""
    nq = t - 1 if nq == "T-1" else nq
    g = torch.Generator().manual_seed(bits + d + gs)
    kc, ks, km = Q.quantize_k_block(torch.randn((B, H, d, t), generator=g),
                                    gs, bits)
    vc, vs, vm = Q.quantize_v_block(torch.randn((B, H, t, d), generator=g),
                                    gs, bits)
    kst = (kc, ks.to(sdt), km.to(sdt))
    qg = torch.randn((B, H, 2, d), generator=g).bfloat16()
    got = qk_model(qg, *kst, gs, bits, nq)
    want = QP.qk_dequant_matmul_plain(qg, *kst, gs, bits, n_quant=nq)
    assert (got[..., nq:] == NEG_INF).all()
    _check(got[..., :nq], want[..., :nq], f"qk gs={gs} d={d} nq={nq}")
    _check_pv((vc, vs.to(sdt), vm.to(sdt)), _p(2, nq, t), gs, bits, nq,
              f"pv gs={gs} d={d} nq={nq}")


def test_models_match_pallas_kernels():
    """The partition against the JAX package's Pallas qk_dequant_matmul
    and pv_dequant_matmul (interpret mode, f32 compute): 2-bit, r = 4,
    n_quant 257 (a second split with one live position) of 1024."""
    t, nq, r, bits = 1024, S + 1, 4, 2
    rng = np.random.default_rng(5)
    k_t = rng.standard_normal((B, H, D, t)).astype(np.float32)
    v = rng.standard_normal((B, H, t, D)).astype(np.float32)
    q = rng.standard_normal((B, H, r, D)).astype(np.float32)
    kc, ks, km = Q.quantize_k_block(torch.from_numpy(k_t), GS, bits)
    vc, vs, vm = Q.quantize_v_block(torch.from_numpy(v), GS, bits)
    jw = lambda w: jnp.asarray(w.numpy().view(np.uint32))  # noqa: E731
    want = np.asarray(j_qk(jnp.asarray(q), jw(kc), jnp.asarray(ks.numpy()),
                           jnp.asarray(km.numpy()), GS, bits, n_quant=nq,
                           compute_dtype=jnp.float32))
    got = qk_model(torch.from_numpy(q), kc, ks, km, GS, bits, nq)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    p = _p(r, nq, t)
    want = np.asarray(j_pv(jnp.asarray(p.numpy()), jw(vc),
                           jnp.asarray(vs.numpy()), jnp.asarray(vm.numpy()),
                           GS, bits, n_quant=nq, compute_dtype=jnp.float32))
    got = pv_model(p, vc, vs, vm, GS, bits, nq).float()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("nq,want", [(0, 1), (1, 1), (S - 1, 1), (S, 1),
                                     (S + 1, 2), (5017, 20), (12032, 47),
                                     (16384, 64)])
def test_split_plan(nq, want):
    """PV's blocks per head: ceil(n_quant / SPLIT), at least one."""
    assert QP.split_plan(nq) == want


def test_pv_workspace_covers_every_n_quant():
    """PV takes the shared workspace for split_plan(T) splits: enough
    partials for every n_quant <= T, and the wide decode kernel's own
    entry at the same shape (one allocation)."""
    from kivi_tpu_torch.kernels import fused_decode_wide as FW
    dev, bh, r = torch.device("cpu"), B * H, 4
    part, ml, tickets = _build.workspace(dev, bh, QP.split_plan(T), r, D)
    for nq in NQ:
        assert part.numel() >= bh * QP.split_plan(nq) * r * D
    assert part.numel() == bh * QP.split_plan(T) * r * D
    assert tickets.shape == (bh,) and (tickets == 0).all()
    assert QP.split_plan(T) == FW.split_plan(T) and QP.SPLIT == FW.SPLIT
    assert _build.workspace(dev, bh, FW.split_plan(T), r, D)[0] is part
