"""The port's one-shot prefill attention (`kernels/flash.py`; on the CPU
its plain version, `flash_attention_plain`) against the JAX package's
Pallas `flash_attention` run in interpret mode, as `tests/test_flash.py`
runs it.

Inputs are made from a seed with numpy and rounded to bf16 first, so both
sides read the same values (the Pallas kernel casts q, k, v to bf16).

Tolerance: the Pallas kernel rounds p to bf16 before PV and its output to
bf16, each at most 2^-8 relative, and the output is a convex combination
of V rows; so |port - Pallas| <= 2 * 2^-8 * max|v| (plus f32 summation
order, ~1e-6).  Padded query rows are exactly 0 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.kernels import flash_attention as j_flash
from kivi_tpu_torch.kernels.flash import flash_attention

torch.set_num_threads(2)


def _bf16(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# (name, B, Hq, Hkv, T, D, sliding window, left pads)
CASES = [
    ("causal", 1, 2, 2, 256, 128, None, None),
    ("gqa_r4", 1, 4, 1, 256, 64, None, None),
    ("window", 1, 2, 2, 256, 128, 64, None),
    ("pad", 2, 2, 2, 256, 128, None, (0, 130)),
    ("fully_padded_row", 2, 2, 1, 128, 64, None, (128, 5)),
    ("one_live_row", 2, 2, 1, 128, 64, None, (127, 0)),
    ("tail", 1, 2, 2, 200, 128, None, None),
    ("tail_pad_window", 2, 4, 1, 200, 64, 48, (0, 77)),
]


@pytest.mark.parametrize("name,B,Hq,Hkv,T,D,sw,pads", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_plain_matches_pallas_interpret(name, B, Hq, Hkv, T, D, sw,
                                              pads):
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (_bf16(rng, (B, Hq, T, D)), _bf16(rng, (B, Hkv, T, D)),
               _bf16(rng, (B, Hkv, T, D)))
    pad = None if pads is None else np.asarray(pads, np.int32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, sliding_window=sw,
                   pad_len=None if pad is None else jnp.asarray(pad))
    want = np.asarray(want.astype(jnp.float32))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), sliding_window=sw,
                          pad_len=None if pad is None else torch.tensor(pad))
    assert got.dtype == torch.float32 and got.shape == (B, Hq, T, D)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * 2.0 ** -8 * np.abs(v).max() + 1e-6)
    if pad is not None:
        for b, p in enumerate(pad):
            assert (got[b, :, :p] == 0).all() and (want[b, :, :p] == 0).all()
            assert (np.abs(got[b, :, p:]).max(axis=-1) > 0).all()


def test_kernel_wrappers_reject_misaligned_tensors():
    """The tensor-core kernels stage with 16-byte cp.async copies: their
    wrappers' alignment check (`_build.check_aligned`) takes a
    16-byte-aligned tensor and refuses a view that starts off the
    boundary."""
    from kivi_tpu_torch.kernels import _build
    x = torch.zeros(64, dtype=torch.bfloat16)
    _build.check_aligned("flash_attention", x, x[8:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.check_aligned("flash_attention", x, x[1:])
