"""Tests of the port's CUDA kernels that need the card (a CUDA kernel has
no CPU mode): each skips without a CUDA device.  This file imports torch
and the port only, so that it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX.)

Tolerances (chip_smoke.py's):
  * the quantizers quantize_pack_k and quantize_pack_v, both entries:
    none; codes, scale and min bit-equal to the plain versions, every
    byte of the stores they write into;
  * the decode probe and row 4's ablated variants: max|kernel - plain|
    <= 1e-5 * max|plain| + 1e-5 (the kernel and the plain version
    compute in f32 from the same bf16 inputs, summed in another order);
  * the one tensor-core tile: 1e-5 relative (exact bf16 products, f32
    sums in another order);
  * the tensor-core kernels flash_attention, flash_extend_attention and
    flash_extend_qhist against their f32 plain versions: each query row
    within utils.tolerance.FLASH_RTOL / EXTEND_RTOL / QHIST_RTOL of its
    own largest value (the reasons are in that module);
  * fp_decode_attention_kernel, the two KIVI decode kernels
    fused_decode_attention_wide and fused_decode_attention, and the split
    decode kernels qk_dequant_matmul and pv_dequant_matmul (f32 on the
    CUDA cores, split over T): max|kernel - plain| <= 1e-5 * max|plain|
    + 1e-5, and two runs bit-equal;
  * the shared-prefix decode route (decode_prefix on the tensor cores,
    then row 6) against fused_decode_attention_plain on caches fanned
    out from one snapshot: each query row within QHIST_RTOL of its own
    largest value.  The prefix pass rounds as row 5 does (K^ = code *
    scale and V^ = code * scale + mn to bf16 once, p to bf16, f32
    accumulation) where the plain version computes in f32, and behind a
    long document the prefix holds nearly all of each row's softmax
    mass; row 6's own part is f32 and adds nothing near that limit;
  * the grouped expert GEMM (row 13, kernels/moe_grouped.py): each
    launch row by row against its plain version, h within
    profile_moe.GATE_RTOL (one bf16 rounding of the row's largest value)
    and the f32 output, given the same h, within DOWN_RTOL (f32 sums in
    another order), beside a control that moves one pair to the next
    expert and must fail (`profile_moe.hold`).
"""

import pytest
import torch

from kivi_tpu_torch import profile_moe as PM
from kivi_tpu_torch import profile_qk_pv as PQ
from kivi_tpu_torch import profile_quant as PQ8
from kivi_tpu_torch import profile_wide_32k as PW
from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import decode_prefix as DPX
from kivi_tpu_torch.kernels import flash as FL
from kivi_tpu_torch.kernels import flash_extend as FE
from kivi_tpu_torch.kernels import fp_decode as FD
from kivi_tpu_torch.kernels import fused_decode as FR
from kivi_tpu_torch.kernels import fused_decode_wide as FW
from kivi_tpu_torch.kernels import moe_grouped as MG
from kivi_tpu_torch.kernels import qk_pv as QP
from kivi_tpu_torch.kernels import quant_pack as QW
from kivi_tpu_torch.utils import tolerance as TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("fill", [2500, 4096])
@pytest.mark.parametrize("bits,r", [(2, 1), (2, 4), (4, 1), (4, 4)])
def test_trimmed_matches_plain(cuda, bits, r, fill):
    """Every variant of the decode ablation probe against its plain
    version and bit-equal across two runs, the attention variants also
    against the plain decode, the wide kernel and the decode route
    against theirs (`profile_wide_32k.check`), on the profiler's cache
    and on a peaked one."""
    for data in PW.DATA:
        PW.check(*PW.make_cache(2, 4096, fill, heads=8, r=r, bits=bits,
                                seed=bits + r, data=data))


def test_profile_wide_32k_check(cuda):
    """`python3 -m kivi_tpu_torch.profile_wide_32k --check` at a 4K
    history."""
    assert PW.main(["--check", "--B", "2", "--T", "4096",
                    "--fill", "4000"]) == []


def test_wide_ablations_match_plain(cuda):
    """Row 4 under every `_ablate` name (the windows live) against
    `fused_decode_attention_wide_plain(_ablate=)` and bit-equal across two
    runs, at the states of `profile_attribution.check` (a strip, the
    window alone, left pads), on the profiler's cache and a peaked one;
    then the ablated entry's refusals."""
    from kivi_tpu_torch import profile_attribution as PA
    assert PA.check(B=2, heads=8, verbose=False) < 1e-4
    qg, c = PW.make_cache(1, 1024, 512, heads=2, r=4)
    with pytest.raises(ValueError, match="r = 1 and bf16 scales"):
        PA.run(qg, c, "window")
    with pytest.raises(ValueError, match="_ablate"):
        FW.fused_decode_attention_wide(
            qg, *PW._stores(c, 1024), c.k_win, c.v_win, 512, 128, 512,
            group_size=32, k_bits=2, v_bits=2, _ablate="everything")


def test_profile_qk_pv(cuda):
    """`python3 -m kivi_tpu_torch.profile_qk_pv --batch 1`: every probe
    build of csrc/qk_pv.cu compiles and launches, and those that compute
    the kernels' function (the runtime-shape and ELEMENT builds) agree
    with the plain versions."""
    out = PQ.main(["--batch", "1"])
    assert {f"B1 {name}" for name in PQ.BUILDS} <= out.keys()


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("mode,n", [("qk", 16), ("qk", 64), ("qk", 128),
                                    ("pv", 64), ("pv", 128)])
def test_wgmma_tile_matches_matmul(cuda, mode, n):
    """One 64 x n x 128 (qk) or 64 x 128 x n (pv) tensor-core tile of
    csrc/attn_wgmma.cuh against torch.matmul: the descriptors, the core
    matrix layout, the accumulator fragment's (row, column) map and the
    P fragment packing, before any softmax."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n)
    a = _randn(gen, (64, 128 if mode == "qk" else n))
    b = _randn(gen, (n, 128))
    want = a.float() @ (b.float().T if mode == "qk" else b.float())
    got = FL.wgmma_tile(a, b, mode)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-5, (mode, n, err)


# (T, KV heads, sliding window, pad, D), as chip_smoke.check_flash, and
# D = 64 in the 128-column tiles
FLASH_CASES = [(1024, 32, None, None, 128), (1000, 32, None, None, 128),
               (1024, 8, None, None, 128), (1024, 32, 256, None, 128),
               (1024, 32, None, "arange", 128), (1024, 32, None, "last", 128),
               (1000, 8, 256, "arange", 64)]


@pytest.mark.parametrize("t,heads,sw,pad,d", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, t, heads, sw, pad, d):
    """Row 10 on the tensor cores against its f32 plain version (B = 2,
    32 query heads), each row within FLASH_RTOL of its own scale; padded
    query rows exactly 0, and a row padded to T - 1 equal to its own V."""
    B = 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(t + heads + d)
    q = _randn(gen, (B, 32, t, d))
    k, v = _randn(gen, (B, heads, t, d)), _randn(gen, (B, heads, t, d))
    pad_len = None
    if pad == "arange":
        pad_len = torch.arange(B, device="cuda", dtype=torch.int32) * 37
    elif pad == "last":
        pad_len = torch.tensor([t - 1, 0], device="cuda", dtype=torch.int32)
    kw = dict(sliding_window=sw, pad_len=pad_len)
    got = FL.flash_attention(q, k, v, **kw)
    want = FL.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    TOL.check_rows(got, want, TOL.FLASH_RTOL,
                   f"flash T={t} Hkv={heads} sw={sw} {pad} D={d}")
    if pad_len is not None:
        rows = torch.arange(t, device="cuda")[None, :] < pad_len[:, None]
        assert (got.float().abs().amax(dim=(1, 3))[rows] == 0).all()
    if pad == "last":
        assert torch.equal(got[0, :, -1], v[0, :, -1].repeat_interleave(
            32 // heads, dim=0))


# (history, pads, sliding window, bits, W, v_flush, D), as
# chip_smoke.check_qhist, and D = 64 in the 128-column tiles
QHIST_CASES = [(12032, None, 0, 2, 32, 32, 128),
               (0, None, 0, 2, 32, 32, 128),
               (3000, None, 0, 4, 32, 32, 128),
               (3000, None, 0, 8, 32, 32, 128),
               (2200, None, 0, 2, 128, 32, 128),
               (3000, (0, 700), 0, 2, 32, 32, 128),
               (3000, (32, 3050), 0, 2, 32, 32, 128),
               (3000, None, 1000, 4, 32, 32, 128),
               (3000, (0, 700), 1000, 4, 32, 32, 64)]


@pytest.mark.parametrize("fill,pads,sw,bits,W,vf,d", QHIST_CASES)
def test_flash_extend_qhist_matches_plain(cuda, fill, pads, sw, bits, W,
                                          vf, d):
    """Row 5 on the tensor cores against its f32 plain version at the
    long slice's geometry (8 KV heads, r = 4, T1 = 128, a 16K cache),
    each row within QHIST_RTOL: rows that see nothing exactly (0, -1e30,
    0)."""
    qcfg = QuantConfig(bits, bits, 32, W, v_flush=vf)
    batch = 1 if pads is None else len(pads)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(fill + bits + d)
    c = KC.init_layer_cache(batch, 8, d, 16384, qcfg, device="cuda")
    if fill:
        KC.prefill_ingest(c, _randn(gen, (batch, 8, fill, d)),
                          _randn(gen, (batch, 8, fill, d)), qcfg)
    qg = _randn(gen, (batch, 8, 4 * 128, d))
    pad_len = (None if pads is None else
               torch.tensor(pads, device="cuda", dtype=torch.int32))
    args = (qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.v_win, c.n_k_quant, c.n_v_quant, c.seq_len)
    kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=128,
              sliding_window=sw, pad_len=pad_len)
    TOL.check_state(FE.flash_extend_qhist(*args, **kw),
                    FE.flash_extend_qhist_plain(*args, **kw), TOL.QHIST_RTOL,
                    f"qhist history={fill} pads={pads} sw={sw} bits={bits} "
                    f"D={d}")


# (history, pads of the two batch rows, sliding window, KV heads, r, bits,
# v_flush, scale dtype, D): chip_smoke.check_extend's main-path fills and
# the kernel's edge cases
EXTEND_CASES = [
    (0, None, 0, 32, 1, 2, 128, "bfloat16", 128),
    (128, None, 0, 32, 1, 2, 128, "bfloat16", 128),
    (896, None, 0, 32, 1, 2, 128, "bfloat16", 128),
    (3000, None, 0, 32, 1, 2, 128, "bfloat16", 128),
    # n_v_quant 96 < n_k_quant 128: window V rows [96, 200) read v_win,
    # the first 32 of them beside quantized K
    (200, None, 0, 32, 1, 2, 32, "bfloat16", 128),
    (896, (64, 64), 0, 32, 1, 2, 128, "bfloat16", 128),   # padded 1st chunk
    (128, (0, 200), 0, 32, 1, 2, 128, "bfloat16", 128),   # pad past history
    (1000, None, 300, 32, 1, 4, 32, "bfloat16", 128),     # sliding window
    (384, (0, 150), 0, 8, 4, 8, 32, "bfloat16", 128),     # GQA, 8-bit
    (896, (0, 37), 0, 32, 1, 2, 128, "float32", 128),     # f32 scales
    (500, (0, 37), 200, 8, 2, 4, 32, "bfloat16", 64),     # D = 64
]


@pytest.mark.parametrize("fill,pads,sw,heads,r,bits,vf,sdt,d", EXTEND_CASES)
def test_flash_extend_attention_matches_plain(cuda, fill, pads, sw, heads,
                                              r, bits, vf, sdt, d):
    """Row 3 on the tensor cores against its f32 plain version (B = 2,
    T1 = 128, a 4K cache), each query row within EXTEND_RTOL of its own
    largest value; and bit-equal across two runs."""
    B, t1 = 2, 128
    qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf, scale_dtype=sdt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(fill + bits + d + heads)
    c = KC.init_layer_cache(B, heads, d, 4096, qcfg, device="cuda")
    if fill:
        KC.prefill_ingest(c, _randn(gen, (B, heads, fill, d)),
                          _randn(gen, (B, heads, fill, d)), qcfg)
    q = _randn(gen, (B, heads, r * t1, d))
    kn, vn = _randn(gen, (B, heads, t1, d)), _randn(gen, (B, heads, t1, d))
    pad_len = (None if pads is None else
               torch.tensor(pads, device="cuda", dtype=torch.int32))
    args = (q, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win, kn, vn, c.n_k_quant, c.n_k_win, c.n_v_quant)
    kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=t1,
              sliding_window=sw, pad_len=pad_len)
    got = FE.flash_extend_attention(*args, **kw)
    TOL.check_rows(got, FE.flash_extend_attention_plain(*args, **kw),
                   TOL.EXTEND_RTOL,
                   f"extend fill={fill} pads={pads} sw={sw} Hkv={heads} "
                   f"r={r} bits={bits} vf={vf} {sdt} D={d} (nkq="
                   f"{c.n_k_quant} nvq={c.n_v_quant})")
    assert torch.equal(got, FE.flash_extend_attention(*args, **kw))


FP_TMAX = 4096
FP_FILLS = (1, 137, 640, 1081, 2048, 3000, 4000, 0)   # chip_smoke.FILLS


def _fp_cache(gen, batch, heads, lens):
    """An fp cache whose whole buffer is random (positions past a row's
    length must not count), holding `lens` (an int, or per-row)."""
    if isinstance(lens, int):
        c = FC.init_fp_cache(batch, heads, 128, FP_TMAX, device="cuda")
        c.length = lens
    else:
        c = FC.init_fp_slot_cache(batch, heads, 128, FP_TMAX, device="cuda")
        c.length.copy_(torch.tensor(lens, device="cuda", dtype=torch.int32))
    c.k.copy_(_randn(gen, c.k.shape))
    c.v.copy_(_randn(gen, c.v.shape))
    return c


def _fp_check(got, want, what):
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all(), what
    assert err <= 1e-5 * want.abs().max().item() + 1e-5, (what, err)


S = FD.SPLIT


@pytest.mark.parametrize("fill", [1, S - 1, S, S + 1, 1081, FP_TMAX])
@pytest.mark.parametrize("heads,r,mask", [(32, 1, None), (8, 4, "pad"),
                                          (32, 1, "swa")])
def test_fp_decode_matches_plain(cuda, fill, heads, r, mask):
    """Row 9 (split over T) against its plain version at host-int fills
    around the split size, with a left pad, a sliding window and GQA;
    two runs bit-equal."""
    B = 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(fill + r)
    c = _fp_cache(gen, B, heads, fill)
    q = _randn(gen, (B, heads, r, 128))
    kw = {}
    if mask == "pad":
        kw["pad_len"] = torch.tensor([0, 37, 300, fill], device="cuda",
                                     dtype=torch.int32)
    elif mask == "swa":
        kw["sliding_window"] = 300
    got = FD.fp_decode_attention_kernel(q, c.k, c.v, fill, **kw)
    _fp_check(got, FD.fp_decode_attention_plain(q, c.k, c.v, fill, **kw),
              f"fp decode fill={fill} Hkv={heads} r={r} {mask}")
    assert torch.equal(got, FD.fp_decode_attention_kernel(q, c.k, c.v, fill,
                                                          **kw))
    if mask == "pad":                  # row 3 padded past its length
        assert (got[3] == 0).all()


@pytest.mark.parametrize("heads,r,mask", [(32, 1, None), (8, 4, "pad"),
                                          (32, 1, "swa"), (8, 8, None)])
def test_fp_decode_rows_match_plain(cuda, heads, r, mask):
    """Per-row lengths (the batcher's slot caches) at chip_smoke's fills,
    0 for an empty slot: within the tolerance, the empty row exactly 0,
    two runs bit-equal."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(r)
    c = _fp_cache(gen, len(FP_FILLS), heads, FP_FILLS)
    q = _randn(gen, (len(FP_FILLS), heads, r, 128))
    kw = {}
    if mask == "pad":
        kw["pad_len"] = torch.tensor([0, 0, 37, 300, 1000, 5, 3999, 0],
                                     device="cuda", dtype=torch.int32)
    elif mask == "swa":
        kw["sliding_window"] = 1000
    got = FD.fp_decode_attention_kernel(q, c.k, c.v, c.length, **kw)
    _fp_check(got, FD.fp_decode_attention_plain(q, c.k, c.v, c.length, **kw),
              f"fp decode per-row Hkv={heads} r={r} {mask}")
    assert (got[FP_FILLS.index(0)] == 0).all()
    assert torch.equal(got, FD.fp_decode_attention_kernel(q, c.k, c.v,
                                                          c.length, **kw))


KS = FW.SPLIT


def _kivi_cache(gen, batch, heads, d, fill, qcfg, tmax=FP_TMAX):
    """A KIVI cache holding `fill` tokens (an int: a layer cache with
    host-int counters; a tuple: a slot cache, one fill per row, 0 an
    empty slot), the last token of each row appended by decode_append."""
    def one(n, rows):
        c = KC.init_layer_cache(rows, heads, d, tmax, qcfg, device="cuda")
        if n > 1:
            KC.prefill_ingest(c, _randn(gen, (rows, heads, n - 1, d)),
                              _randn(gen, (rows, heads, n - 1, d)), qcfg)
        if n:
            KC.decode_append(c, _randn(gen, (rows, heads, 1, d)),
                             _randn(gen, (rows, heads, 1, d)), qcfg)
        return c
    if isinstance(fill, int):
        return one(fill, batch)
    slots = KC.init_slot_cache(len(fill), heads, d, tmax, qcfg,
                               device="cuda")
    for s_, n in enumerate(fill):
        KC.write_slot(slots, s_, one(n, 1))
    return slots


def _cache_arrays(c):
    return (c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win)


# (fill, bits, v_flush, lower bound, KV heads, r, scale dtype, D): fills
# at the edges of the kernel's splits and the main path's 1081 (B = 4);
# "span" is a hand-set state (n_k_quant 200, n_k_win 100, n_v_quant 180,
# W 128) whose window spans the first two splits and whose first split
# straddles n_v_quant < n_k_quant
WIDE_CASES = [(fill, 2, 128, None, 32, 1, "bfloat16", 128)
              for fill in (1, KS - 1, KS, KS + 1, 1081, 2 * KS + 57,
                           FP_TMAX)]
WIDE_CASES += [
    (1081, 4, 128, None, 32, 1, "bfloat16", 128),
    (1081, 8, 128, None, 32, 1, "bfloat16", 128),
    (2 * KS + 57, 2, 32, None, 32, 1, "bfloat16", 128),   # nvq < nkq
    ("span", 2, 128, None, 32, 1, "bfloat16", 128),
    ("span", 4, 128, "pad", 8, 4, "bfloat16", 128),
    (1081, 2, 128, "pad", 32, 1, "bfloat16", 128),   # lo kills splits
    (1081, 4, 32, "swa", 32, 1, "bfloat16", 128),
    (1081, 2, 128, "pad", 8, 4, "bfloat16", 128),
    (1081, 8, 32, None, 8, 8, "float32", 128),
    (2 * KS + 57, 4, 32, "pad", 8, 4, "float32", 64),
]


def _lo(mask, batch, seq_len):
    if mask == "pad":      # row 1 loses whole splits, row 3 everything
        return torch.tensor([0, 600, 37, seq_len][:batch], device="cuda",
                            dtype=torch.int32)
    if mask == "swa":
        return torch.full((batch,), max(seq_len - 300, 0), device="cuda",
                          dtype=torch.int32)
    return None


@pytest.mark.parametrize("fill,bits,vf,mask,heads,r,sdt,d", WIDE_CASES)
def test_fused_decode_wide_matches_plain(cuda, fill, bits, vf, mask, heads,
                                         r, sdt, d):
    """Row 4 (split over T) against its plain version at host-int fills
    around the split size, a window across two splits, n_v_quant <
    n_k_quant, left pads and windows that kill whole splits, bits
    2/4/8, r 1/4/8, f32 scales and D = 64; two runs bit-equal, a row
    padded past its last token exactly 0."""
    B = 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(bits + r + d)
    if fill == "span":
        q, c = PW.make_cache(B, FP_TMAX, 200, heads=heads, r=r, bits=bits,
                             seed=bits + r, data="normal")
        c.n_k_win, c.n_v_quant, c.n_v_win = 100, 180, 120
    else:
        qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf,
                           scale_dtype=sdt)
        c = _kivi_cache(gen, B, heads, d, fill, qcfg)
        q = _randn(gen, (B, heads, r, d))
    args = (q, *_cache_arrays(c), c.n_k_quant, c.n_k_win, c.n_v_quant)
    kw = dict(group_size=32, k_bits=bits, v_bits=bits,
              lo=_lo(mask, B, c.seq_len))
    got = FW.fused_decode_attention_wide(*args, **kw)
    want = FW.fused_decode_attention_wide_plain(*args, **kw)
    # a row whose bound lies past its last token sees nothing: the kernel
    # writes zeros, where the plain version (the JAX split softmax) is
    # undefined
    live = (torch.ones(B, dtype=torch.bool, device="cuda") if kw["lo"] is None
            else kw["lo"] < c.seq_len)
    _fp_check(got[live], want[live],
              f"wide fill={fill} bits={bits} vf={vf} {mask} Hkv={heads} "
              f"r={r} {sdt} D={d} (nkq={c.n_k_quant} nkw={c.n_k_win} "
              f"nvq={c.n_v_quant})")
    assert torch.equal(got, FW.fused_decode_attention_wide(*args, **kw))
    assert (got[~live] == 0).all()


def test_fused_decode_wide_control_refused(cuda):
    """A control: the kernel's own output without its first split (a
    lower bound at the split size) must miss the plain version, so the
    tolerance sees a missing split."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    c = _kivi_cache(gen, 4, 32, 128, 1081, QuantConfig(2, 2, 32, 128))
    q = _randn(gen, (4, 32, 1, 128))
    args = (q, *_cache_arrays(c), c.n_k_quant, c.n_k_win, c.n_v_quant)
    kw = dict(group_size=32, k_bits=2, v_bits=2)
    want = FW.fused_decode_attention_wide_plain(*args, **kw)
    _fp_check(FW.fused_decode_attention_wide(*args, **kw), want, "wide")
    ctrl = FW.fused_decode_attention_wide(*args, **kw, lo=torch.full(
        (4,), KS, device="cuda", dtype=torch.int32))
    err = (ctrl - want).abs().max().item()
    assert err > 10 * (1e-5 * want.abs().max().item() + 1e-5), err


# (bits, v_flush, KV heads, r, lower bound, scale dtype)
ROWS_CASES = [(2, 128, 32, 1, None, "bfloat16"),
              (2, 32, 32, 1, "pad", "bfloat16"),
              (4, 32, 8, 4, "pad", "bfloat16"),
              (8, 32, 8, 8, None, "bfloat16"),
              (4, 32, 32, 1, "swa", "float32"),
              (8, 128, 8, 4, "swa", "bfloat16")]


@pytest.mark.parametrize("bits,vf,heads,r,mask,sdt", ROWS_CASES)
def test_fused_decode_rows_match_plain(cuda, bits, vf, heads, r, mask,
                                       sdt):
    """Row 6 (per-row device counters, split over T) at chip_smoke's
    FILLS: within the tolerance, the empty slot exactly 0, two runs
    bit-equal."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(bits + r)
    qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf, scale_dtype=sdt)
    c = _kivi_cache(gen, 0, heads, 128, FP_FILLS, qcfg)
    q = _randn(gen, (len(FP_FILLS), heads, r, 128))
    lo = None
    if mask == "pad":
        lo = torch.tensor([0, 0, 37, 300, 1000, 5, 3999, 0], device="cuda",
                          dtype=torch.int32)
    elif mask == "swa":
        lo = torch.clamp(c.seq_len - 1000, min=0)
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    args = (q, *_cache_arrays(c), counts)
    kw = dict(group_size=32, k_bits=bits, v_bits=bits, lo=lo)
    got = FR.fused_decode_attention(*args, **kw)
    _fp_check(got, FR.fused_decode_attention_plain(*args, **kw),
              f"rows bits={bits} vf={vf} Hkv={heads} r={r} {mask} {sdt}")
    assert (got[FP_FILLS.index(0)] == 0).all()
    assert torch.equal(got, FR.fused_decode_attention(*args, **kw))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fused_decode_rows_uniform_equal_wide(cuda, bits):
    """At counters equal on every row, row 6 computes row 4's function."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(bits)
    c = _kivi_cache(gen, 4, 32, 128, 1081,
                    QuantConfig(bits, bits, 32, 128, v_flush=32))
    q = _randn(gen, (4, 32, 1, 128))
    kw = dict(group_size=32, k_bits=bits, v_bits=bits,
              lo=torch.tensor([0, 37, 600, 0], device="cuda",
                              dtype=torch.int32))
    counts = torch.tensor([[c.n_k_quant, c.n_k_win, c.n_v_quant]] * 4,
                          device="cuda", dtype=torch.int32)
    got = FR.fused_decode_attention(q, *_cache_arrays(c), counts, **kw)
    _fp_check(got, FW.fused_decode_attention_wide(
        q, *_cache_arrays(c), c.n_k_quant, c.n_k_win, c.n_v_quant, **kw),
        f"rows vs wide bits={bits}")


# (bits, r, D, scale dtype) of the split decode kernels, rows 7 and 8, at
# the long slice's batch 1 and 8 KV heads, a cache of QKPV_TMAX filled to
# 6001 (W = 32); every case runs at each n_quant of _qkpv_nqs
QKPV_CASES = [(2, 1, 128, "bfloat16"), (2, 2, 128, "bfloat16"),
              (2, 4, 128, "bfloat16"), (2, 8, 128, "bfloat16"),
              (4, 4, 128, "bfloat16"), (8, 4, 128, "bfloat16"),
              (8, 2, 128, "float32"), (4, 1, 64, "float32"),
              (2, 4, 64, "float32"), (8, 8, 64, "bfloat16")]
QKPV_TMAX = 8192


def _qkpv_cache(bits, r, d, sdt):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(bits + r + d)
    qcfg = QuantConfig(bits, bits, 32, 32, scale_dtype=sdt)
    c = _kivi_cache(gen, 1, 8, d, 6001, qcfg, tmax=QKPV_TMAX)
    return gen, c


def _qkpv_nqs(c):
    """Split edges, a group edge inside a split (5017), the cache's
    count and all of T."""
    return (0, 1, KS - 1, KS, KS + 1, 5017, c.n_k_quant, QKPV_TMAX)


def _poisoned(x, start: int, axis: int):
    """A copy of a float store whose entries from `start` on along `axis`
    are NaN: a kernel that read them would show it."""
    x = x.clone()
    x.narrow(axis, start, x.shape[axis] - start).fill_(float("nan"))
    return x


@pytest.mark.parametrize("bits,r,d,sdt", QKPV_CASES)
def test_qk_dequant_matches_plain(cuda, bits, r, d, sdt):
    """Row 7 at every n_quant of _qkpv_nqs: positions >= n_quant exactly
    -1e30, the rest within the tolerance of the plain version, two runs
    bit-equal; the scale and min rows of groups wholly past n_quant are
    NaN, so a read of them would show."""
    gen, c = _qkpv_cache(bits, r, d, sdt)
    q = _randn(gen, (1, 8, r, d))
    for nq in _qkpv_nqs(c):
        _qk_check(q, c.k_codes, c.k_scale, c.k_mn, 32, bits, nq,
                  f"qk bits={bits} r={r} D={d} {sdt} nq={nq}")


def _qk_check(q, codes, scale, mn, gs, bits, nq, what):
    g = -(-nq // gs)
    kargs = (codes, _poisoned(scale, g, 2), _poisoned(mn, g, 2), gs, bits)
    want = QP.qk_dequant_matmul_plain(q, *kargs, n_quant=nq)
    got = QP.qk_dequant_matmul(q, *kargs, n_quant=nq)
    assert (got[..., nq:] == -1e30).all(), what
    if nq:
        _fp_check(got[..., :nq], want[..., :nq], what)
    assert torch.equal(got, QP.qk_dequant_matmul(q, *kargs, n_quant=nq)), what


def _pv_check(p, codes, scale, mn, gs, bits, nq, what):
    p = _poisoned(p, nq, 3)
    vargs = (codes, _poisoned(scale, nq, 3), _poisoned(mn, nq, 3), gs, bits)
    got = QP.pv_dequant_matmul(p, *vargs, n_quant=nq)
    _fp_check(got, QP.pv_dequant_matmul_plain(p, *vargs, n_quant=nq), what)
    if nq == 0:
        assert (got == 0).all(), what
    assert torch.equal(got, QP.pv_dequant_matmul(p, *vargs, n_quant=nq)), what


@pytest.mark.parametrize("bits,r,d,sdt", QKPV_CASES)
def test_pv_dequant_matches_plain(cuda, bits, r, d, sdt):
    """Row 8 at every n_quant of _qkpv_nqs, p a softmax over the first
    n_quant positions: within the tolerance of the plain version, zeros
    at n_quant 0, two runs bit-equal; p and the V scale and min columns
    past n_quant are NaN, so a read of them would show."""
    gen, c = _qkpv_cache(bits, r, d, sdt)
    for nq in _qkpv_nqs(c):
        _pv_check(_softmax_p(gen, (1, 8, r, QKPV_TMAX), nq), c.v_codes,
                  c.v_scale, c.v_mn, 32, bits, nq,
                  f"pv bits={bits} r={r} D={d} {sdt} nq={nq}")


def _softmax_p(gen, shape, nq):
    """A softmax over the first nq positions, exactly 0 past them."""
    pos = torch.arange(shape[-1], device="cuda")
    return torch.softmax(torch.randn(shape, generator=gen, device="cuda")
                         .masked_fill(pos >= nq, float("-inf")),
                         dim=-1).nan_to_num(0.0)


# (bits, r, D, group size, scale dtype, T) at the edges of rows 7 and 8's
# contract (D <= 128 with 128 % gs == 0, T a multiple of 4): group sizes
# 1 and 2 (a thread's position or channel pair spans two groups, and
# shared memory takes the split's groups in several tiles at r = 8 and
# f32 scales), 4, 8 and 128; D not a multiple of 8 (scale rows in 8-byte
# copies); bf16 columns with T % 8 == 4 (8-byte copies)
QKPV_EDGES = [(2, 8, 128, 1, "float32", 2048),
              (4, 4, 128, 2, "float32", 1028),
              (2, 2, 64, 1, "bfloat16", 1028),
              (8, 8, 4, 4, "bfloat16", 516),
              (8, 2, 12, 2, "float32", 1000),
              (8, 1, 124, 4, "bfloat16", 772),
              (4, 8, 24, 8, "bfloat16", 776),
              (2, 4, 128, 128, "bfloat16", 1024)]


@pytest.mark.parametrize("bits,r,d,gs,sdt,t", QKPV_EDGES)
def test_qk_pv_contract_edges(cuda, bits, r, d, gs, sdt, t):
    """Rows 7 and 8 at the edges of their contract, B = 1, 2 KV heads,
    stores quantized from N(0, 1), n_quant 0, 1, 3, 255, 257, T - 1 and
    T: within the tolerance of the plain versions, -1e30 and zeros where
    the contract says, two runs bit-equal, nothing read past n_quant."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(bits + d + gs + t)
    dt = getattr(torch, sdt)
    kc, ks, km = Q.quantize_k_block(torch.randn(
        (1, 2, d, t), generator=gen, device="cuda"), gs, bits)
    vc, vs, vm = Q.quantize_v_block(torch.randn(
        (1, 2, t, d), generator=gen, device="cuda"), gs, bits)
    q = _randn(gen, (1, 2, r, d))
    for nq in (0, 1, 3, KS - 1, KS + 1, t - 1, t):
        what = f"bits={bits} r={r} D={d} gs={gs} {sdt} T={t} nq={nq}"
        _qk_check(q, kc.contiguous(), ks.to(dt).contiguous(),
                  km.to(dt).contiguous(), gs, bits, nq, "qk " + what)
        _pv_check(_softmax_p(gen, (1, 2, r, t), nq), vc.contiguous(),
                  vs.to(dt).contiguous(), vm.to(dt).contiguous(), gs, bits,
                  nq, "pv " + what)


def test_qk_pv_controls_refused(cuda):
    """Controls: PV on p whose first split is zeroed, and QK against a
    plain version whose first split's keys changed, must both miss by
    more than the tolerance."""
    gen, c = _qkpv_cache(2, 4, 128, "bfloat16")
    nq = c.n_k_quant
    q = _randn(gen, (1, 8, 4, 128))
    kargs = (c.k_codes, c.k_scale, c.k_mn, 32, 2)
    moved = c.k_codes.clone()
    moved[..., :KS] ^= 0x55555555      # every code of the first split
    want = QP.qk_dequant_matmul_plain(q, moved, *kargs[1:], n_quant=nq)
    got = QP.qk_dequant_matmul(q, *kargs, n_quant=nq)
    err = (got[..., :nq] - want[..., :nq]).abs().max().item()
    assert err > 10 * (1e-5 * want[..., :nq].abs().max().item() + 1e-5), err
    p = torch.softmax(torch.randn((1, 8, 4, QKPV_TMAX), generator=gen,
                                  device="cuda")[..., :nq], dim=-1)
    p = torch.nn.functional.pad(p, (0, QKPV_TMAX - nq))
    vargs = (c.v_codes, c.v_scale, c.v_mn, 32, 2)
    want = QP.pv_dequant_matmul_plain(p, *vargs, n_quant=nq)
    _fp_check(QP.pv_dequant_matmul(p, *vargs, n_quant=nq), want, "pv")
    cut = p.clone()
    cut[..., :KS] = 0.0
    err = (QP.pv_dequant_matmul(cut, *vargs, n_quant=nq) - want).abs().max()
    assert err.item() > 10 * (1e-5 * want.abs().max().item() + 1e-5), err


# ---------------------------------------------------------------------------
# rows 1-2: the quantizers, both entries (kivi_tpu_torch.profile_quant's
# checkers: codes, scale and min bit-equal to the plain versions, whole
# stores pre-filled with a sentinel, two runs bit-equal)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [32, 128, 1024])
@pytest.mark.parametrize("gs", [32, 16])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("is_key", [True, False])
def test_quantize_pack_matches_plain(cuda, is_key, bits, gs, T):
    """The contract entry (fresh outputs) on contiguous blocks and on the
    first T tokens of a longer one; gs 16 takes the runtime-shape
    kernel."""
    for layout in ("contiguous", "window"):
        PQ8.check_fresh(is_key, bits, gs, (2, 8, T, 128), layout)


@pytest.mark.parametrize("shape,gs,bits", [
    ((2, 4, 64, 64), 32, 2), ((1, 2, 32, 96), 32, 4),
    ((1, 2, 48, 80), 16, 4), ((1, 3, 8, 12), 4, 8),
    ((2, 2, 128, 128), 128, 2), ((1, 2, 4, 128), 1, 8)])
@pytest.mark.parametrize("is_key", [True, False])
def test_quantize_pack_runtime_shapes(cuda, is_key, shape, gs, bits):
    """The rest of the contract (D and gs other than 128 and 32, D not a
    multiple of 8) and a base that is not 16-byte aligned."""
    for layout in ("contiguous", "window", "unaligned"):
        PQ8.check_fresh(is_key, bits, gs, shape, layout)


@pytest.mark.parametrize("mode", list(PQ8.MODES))
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [32, 128, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("is_key", [True, False])
def test_quantize_pack_into_matches_plain(cuda, is_key, bits, n, sdt, mode):
    """The in-place entry: selected rows (all, one, none, every, one host
    offset) at offsets 0, 128, Tmax (clamped) and 130, bf16 and f32
    stores, the V block a token-strided window view; every store equal to
    the plain version's, the control refused."""
    PQ8.check_into(is_key, bits, 32, n, sdt, mode)


@pytest.mark.parametrize("case", list(PQ8.MAIN_PATH_INTO))
@pytest.mark.parametrize("is_key", [True, False])
def test_quantize_pack_into_main_path_shapes(cuda, is_key, case):
    """The in-place entry at the shapes the main path gives it: the
    batcher's flush (device offsets, no / one / every row), the one-shot
    ingest and the long slice's flush and chunk (host offsets)."""
    B, H, n, tmax, modes, host_off = case
    for mode in modes:
        PQ8.check_into(is_key, 2, 32, n, torch.bfloat16, mode, B=B, H=H,
                       tmax=tmax, host_off=host_off)


@pytest.mark.parametrize("gs,d", [(16, 128), (32, 64), (8, 24)])
@pytest.mark.parametrize("is_key", [True, False])
def test_quantize_pack_into_runtime_shapes(cuda, is_key, gs, d):
    """The in-place entry through the runtime-shape kernel."""
    for mode in ("all", "one", "host"):
        PQ8.check_into(is_key, 8 if d == 24 else 2, gs, 32, torch.bfloat16,
                       mode, D_=d)


def test_quantize_pack_into_control_refused(cuda):
    """The checker refuses a kernel run whose one row was left out: the
    in-place entry with row 0's predicate off, held to the plain version
    with it on."""
    x = torch.randn((4, 8, 128, 128), device="cuda").to(torch.bfloat16)
    off = torch.tensor([0, 128, 256, 384], dtype=torch.int32, device="cuda")
    pred = torch.ones(4, dtype=torch.bool, device="cuda")
    got = PQ8.stores(True, 4, 8, 128, 512, 2, 32, torch.bfloat16)
    want = PQ8.stores(True, 4, 8, 128, 512, 2, 32, torch.bfloat16)
    cut = pred.clone()
    cut[0] = False
    QW.quantize_pack_k_into(x, 32, 2, *got, off, cut)
    QW.quantize_pack_k_into_plain(x, 32, 2, *want, off, pred)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want))


def test_quantize_pack_into_raises(cuda):
    """A CUDA tensor the kernel refuses raises (no fallback): f16 stats,
    a host offset past the store, offsets on the host."""
    x = torch.zeros((2, 8, 32, 128), dtype=torch.bfloat16, device="cuda")
    st = PQ8.stores(True, 2, 8, 128, 64, 2, 32, torch.float16)
    with pytest.raises(TypeError):
        QW.quantize_pack_k_into(x, 32, 2, *st, 0)
    st = PQ8.stores(True, 2, 8, 128, 64, 2, 32, torch.float32)
    with pytest.raises(ValueError):
        QW.quantize_pack_k_into(x, 32, 2, *st, 48)
    with pytest.raises(ValueError):
        QW.quantize_pack_k_into(x, 32, 2, *st,
                                torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the shared-prefix decode route (kernels/decode_prefix.py)
# ---------------------------------------------------------------------------

SHARED_QCFG = dict(k_bits=2, v_bits=2, group_size=32, residual_length=128,
                   v_flush=128)


def _fanned(gen, rows, doc, heads=8, d=128, sdt="bfloat16", seed_off=0):
    """A slot cache of `rows` rows fanned out from one snapshot of a
    `doc`-token document (Tmax 12288, KIVI-2, W 128): row b extended by a
    64-token question (96 for every fifth row, which leaves its K window
    empty) and then b * 7 % 100 decode appends, as the engine's rows
    are.  Returns (the snapshot, the slot cache)."""
    qcfg = QuantConfig(**SHARED_QCFG, scale_dtype=sdt)
    tmax = 12288
    snap = KC.init_layer_cache(1, heads, d, tmax, qcfg, device="cuda")
    KC.prefill_ingest(snap, _randn(gen, (1, heads, doc, d)),
                      _randn(gen, (1, heads, doc, d)), qcfg)
    slots = KC.init_slot_cache(rows, heads, d, tmax, qcfg, device="cuda")
    for b in range(rows):
        one = KC.init_layer_cache(1, heads, d, tmax, qcfg, device="cuda")
        KC.broadcast_rows_into(one, snap)
        n = 96 if b % 5 == 4 else 64
        KC.prefill_extend(one, _randn(gen, (1, heads, n, d)),
                          _randn(gen, (1, heads, n, d)), qcfg, doc)
        for _ in range(0 if b % 5 == 4 else b * 7 % 100):
            KC.decode_append(one, _randn(gen, (1, heads, 1, d)),
                             _randn(gen, (1, heads, 1, d)), qcfg)
        KC.write_slot(slots, b, one)
    return snap, slots


def _route_args(c, q):
    counts = torch.stack([c.n_k_quant, c.n_k_win, c.n_v_quant], dim=1)
    return (q, *_cache_arrays(c), counts)


# (rows, document tokens, r, scale dtype, lower bound)
SHARED_CASES = [(8, 2048, 4, "bfloat16", None),
                (8, 2048, 1, "float32", None),
                (8, 2048, 4, "bfloat16", "swa"),
                (96, 12000, 4, "bfloat16", None),
                (96, 12000, 1, "bfloat16", None)]


@pytest.mark.parametrize("rows,doc,r,sdt,mask", SHARED_CASES)
def test_shared_route_matches_plain(cuda, rows, doc, r, sdt, mask):
    """The route at the engine's geometry (8 KV heads, D 128, KIVI-2, W
    128) behind a 2K and a 12K document, 8 and 96 rows, r 1 and 4, bf16
    and f32 scales, a sliding window whose bound lies inside the prefix:
    every query row within QHIST_RTOL of fused_decode_attention_plain
    (no prefix) over the same fanned-out caches; two runs bit-equal."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(rows + doc + r)
    snap, c = _fanned(gen, rows, doc, sdt=sdt)
    shared = DPX.shared_positions(snap.n_k_quant, snap.n_v_quant, 32)
    # the snapshot's quantized values: (doc - 1) // 128 * 128
    assert shared == (doc - 1) // 128 * 128
    q = _randn(gen, (rows, 8, r, 128))
    args = _route_args(c, q)
    lo = (None if mask is None else
          torch.clamp(c.seq_len - (doc - 700), min=0).to(torch.int32))
    kw = dict(group_size=32, k_bits=2, v_bits=2, lo=lo)
    got = DPX.shared_decode_attention(*args, shared=shared, **kw)
    want = FR.fused_decode_attention_plain(*args, **kw)
    TOL.check_rows(got, want, TOL.QHIST_RTOL,
                   f"shared route rows={rows} doc={doc} r={r} {sdt} {mask}")
    assert torch.equal(got, DPX.shared_decode_attention(
        *args, shared=shared, **kw))


def test_shared_route_prefix_pass_matches_plain(cuda):
    """The prefix pass alone: its split states, merged, against
    decode_prefix_plain's within QHIST_RTOL (TOL.check_state), and a
    control that drops the first half of its splits refused."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    snap, c = _fanned(gen, 8, 4000)
    shared = DPX.shared_positions(snap.n_k_quant, snap.n_v_quant, 32)
    q = _randn(gen, (8, 8, 4, 128))
    kw = dict(shared=shared, group_size=32, k_bits=2, v_bits=2)
    acc, ml = DPX.decode_prefix(q, *_cache_arrays(c)[:6], **kw)
    acc_p, ml_p = DPX.decode_prefix_plain(q, *_cache_arrays(c)[:6], **kw)
    assert acc.shape[1] > 1

    def merged(acc, ml):
        m, l = ml[..., 0], ml[..., 1]
        live = l > 0
        M = torch.where(live, m, torch.full_like(m, -1e30)).amax(1)
        w = torch.where(live, torch.exp(m - M[:, None]), 0.0)
        return (acc * w[..., None]).sum(1), M, (l * w).sum(1)

    TOL.check_state(merged(acc, ml), merged(acc_p, ml_p), TOL.QHIST_RTOL,
                    "decode_prefix")
    n = acc.shape[1]
    ctrl = merged(acc[:, n // 2:], ml[:, n // 2:])
    with pytest.raises(AssertionError):
        TOL.check_state(ctrl, merged(acc_p, ml_p), TOL.QHIST_RTOL,
                        "decode_prefix without its first split")


def test_shared_route_graph_two_documents(cuda):
    """The route captured in a CUDA graph over fixed cache tensors and
    replayed for two jobs of different documents (each copied into those
    tensors): each replay gives its own job's result."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    jobs = [_fanned(gen, 8, 2048) for _ in range(2)]
    shared = DPX.shared_positions(jobs[0][0].n_k_quant,
                                  jobs[0][0].n_v_quant, 32)
    qs = [_randn(gen, (8, 8, 4, 128)) for _ in range(2)]
    static = _fanned(gen, 8, 2048)[1]
    q = torch.empty_like(qs[0])
    kw = dict(shared=shared, group_size=32, k_bits=2, v_bits=2)

    def load(j):
        for f in ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
                  "k_win", "v_win", "n_k_quant", "n_k_win", "n_v_quant",
                  "n_v_win"):
            getattr(static, f).copy_(getattr(jobs[j][1], f))
        q.copy_(qs[j])

    out = {}

    def body():
        out["o"] = DPX.shared_decode_attention(*_route_args(static, q), **kw)

    load(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for j in (0, 1, 0):
        load(j)
        graph.replay()
        torch.cuda.synchronize()
        want = FR.fused_decode_attention_plain(
            *_route_args(jobs[j][1], qs[j]), group_size=32, k_bits=2,
            v_bits=2)
        TOL.check_rows(out["o"], want, TOL.QHIST_RTOL, f"graph job {j}")


def test_shared_route_kernel_names(cuda):
    """Every kernel the route launches carries row 6's name fragment
    (`Ablation<0>, true>`, kvbench/readers.py's ROW6): the prefix pass
    and row 6, and nothing else."""
    from torch.autograd import DeviceType
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    snap, c = _fanned(gen, 8, 2048)
    shared = DPX.shared_positions(snap.n_k_quant, snap.n_v_quant, 32)
    args = _route_args(c, _randn(gen, (8, 8, 4, 128)))
    kw = dict(shared=shared, group_size=32, k_bits=2, v_bits=2)
    DPX.shared_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        DPX.shared_decode_attention(*args, **kw)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert any("prefix_kernel" in n for n in names), names
    assert any("decode_kernel" in n for n in names), names
    assert all("Ablation<0>, true>" in n for n in names), names


# tokens, skewed routing, first held expert: the K-EXAONE cell's decode
# step (row tiles of 32) and a prompt call (row tiles of 128), a count no
# tile divides, a shard other than the first
MOE_CASES = [(256, False, 0), (256, True, 0), (37, True, 0),
             (4000, False, 0), (4000, True, 0), (256, True, 48)]


@pytest.mark.parametrize("n,skew,first", MOE_CASES)
def test_moe_grouped_matches_plain(cuda, n, skew, first):
    """Row 13's two launches against their plain versions at the cell's
    widths (hidden 6144, experts of 2048, 16 held, top-8), the skewed
    routings putting every token on two held experts and none on two
    others (`profile_moe.hold`)."""
    res = PM.hold(*PM.inputs(n, seed=n + first, skew=skew, first=first),
                  first=first, what=f"N={n} skew={skew} first={first}")
    if skew:
        assert res["counts_min_max"] == [0, n]
    for name in ("gate_up", "down"):
        assert res[name]["worst_share"] <= 1 < res[name]["control_share"]


def test_moe_grouped_graph_replay(cuda):
    """`moe_grouped.experts` captured in a CUDA graph over fixed input
    tensors and replayed for three routings (each copied into them): each
    replay within one bf16 rounding of the eager call on its own inputs
    (the down launch adds a token's pairs in no fixed order)."""
    calls = [PM.inputs(256, seed=s, skew=s == 2) for s in range(3)]
    wg, wu, wd = calls[0][3:]
    x, idx, w = (t.clone() for t in calls[0][:3])
    out = {}

    def body():
        out["o"] = MG.experts(x, idx, w, wg, wu, wd, 0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for j in (1, 2, 0):
        for dst, src in zip((x, idx, w), calls[j][:3]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = MG.experts(*calls[j][:3], wg, wu, wd, 0)
        TOL.check_rows(out["o"], want, PM.GATE_RTOL, f"graph routing {j}")


def test_moe_grouped_kernel_names(cuda):
    """Both launches carry the name fragment `moe_grouped` that
    kvbench's expert_roofline.gen reads, and a call launches no other
    kernel of this library."""
    from torch.autograd import DeviceType
    x, idx, w, wg, wu, wd = PM.inputs(256)
    tok, ws, off, _, P = MG.plan(idx, w, 0, wg.shape[0])
    out = torch.zeros(256, wd.shape[-1], dtype=torch.float32, device="cuda")
    MG.down(MG.gate_up(x, tok, off, wg, wu, P), tok, ws, off, wd, out)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        MG.down(MG.gate_up(x, tok, off, wg, wu, P), tok, ws, off, wd, out)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("moe_grouped" in n for n in names) == 2, names
