"""Tests of the port's CUDA kernels that need the card (a CUDA kernel has
no CPU mode): each skips without a CUDA device.  This file imports torch
and the port only, so that it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX.)

Tolerances (chip_smoke.py's):
  * the decode probe: max|kernel - plain| <= 1e-5 * max|plain| + 1e-5
    (the kernel and the plain version compute in f32 from the same bf16
    inputs, summed in another order);
  * the one tensor-core tile: 1e-5 relative (exact bf16 products, f32
    sums in another order);
  * the tensor-core kernels flash_attention and flash_extend_qhist
    against their f32 plain versions: each query row within
    utils.tolerance.FLASH_RTOL / QHIST_RTOL of its own largest value
    (the reasons are in that module).
"""

import pytest
import torch

from kivi_tpu_torch import profile_wide_32k as PW
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.kernels import flash as FL
from kivi_tpu_torch.kernels import flash_extend as FE
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
    from kivi_tpu_torch.cache import kivi_cache as KC
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
