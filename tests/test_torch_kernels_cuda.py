"""Tests of the port's CUDA kernels that need the card (a CUDA kernel has
no CPU mode): each skips without a CUDA device.  This file imports torch
and the port only, so that it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX.)

Tolerance: chip_smoke.py's attention tolerance, max|kernel - plain| <=
1e-5 * max|plain| + 1e-5 (the kernel and the plain version compute in
f32 from the same bf16 inputs, summed in another order).
"""

import pytest
import torch

from kivi_tpu_torch import profile_wide_32k as PW


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
