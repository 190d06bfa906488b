"""The port's full extend attention (`kernels/flash_extend.py`
`flash_extend_attention`; on the CPU its plain version,
`flash_extend_attention_plain`) against the JAX package's Pallas
`flash_extend_attention` run in interpret mode at its default
compute_dtype=bf16, as the chunked prefill runs it.

Caches are built by the JAX package from seeded numpy inputs and copied
into the port's layout (uint32 words as int32), so both read the same
bits; queries and the new keys and values are rounded to bf16 first.
Shapes satisfy `flash_extend_full_supported` (W = 128, 512-position
chunks of a 1024-token cache).

Tolerance: per query row, utils.tolerance.EXTEND_RTOL = 8 * 2^-8 of the
row's largest value.  The Pallas kernel rounds its operands to bf16
(K^ = code * scale, V^ = code * scale + mn, q . mn, p) where the plain
version computes in f32; these are the roundings the CUDA kernel makes,
and the limit's reasons are in that module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache import kivi_cache as JC
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.kernels.flash_extend import flash_extend_attention as j_full
from kivi_tpu.kernels.flash_extend import flash_extend_full_supported
from kivi_tpu_torch.cache.kivi_cache import KiviLayerCache
from kivi_tpu_torch.kernels.flash_extend import flash_extend_attention
from kivi_tpu_torch.utils import tolerance as TOL

torch.set_num_threads(2)

B, H, D, TMAX, W = 2, 2, 64, 1024, 128


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _cache(bits, prompt, steps, vf, seed):
    jq = JQuantConfig(k_bits=bits[0], v_bits=bits[1], group_size=32,
                      residual_length=W, v_flush=vf)
    rng = np.random.default_rng(seed)
    n = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    cache = JC.init_layer_cache(B, H, D, TMAX, jq)
    cache = JC.prefill_ingest(cache, n(B, H, prompt, D), n(B, H, prompt, D),
                              jq)
    step = jax.jit(lambda c, k, v: JC.decode_append(c, k, v, jq))
    for _ in range(steps):
        cache = step(cache, n(B, H, 1, D), n(B, H, 1, D))
    return cache


# (name, (k_bits, v_bits), prompt, decode steps, v_flush, T1, r, sliding
# window, left pads)
CASES = [
    ("no_history", (2, 2), 40, 0, 32, 16, 2, 0, None),
    ("flushed", (2, 2), 128, 0, 32, 16, 2, 0, None),
    # v_flush 32: n_v_quant trails n_k_quant, window V rows beside
    # quantized K
    ("midstream", (4, 4), 200, 60, 32, 32, 1, 0, None),
    ("mixed_bits", (2, 4), 190, 140, 128, 16, 2, 0, None),
    ("gqa_r4_8bit", (8, 8), 300, 0, 32, 16, 4, 0, None),
    ("pad", (2, 2), 330, 0, 32, 16, 2, 0, (0, 70)),
    ("window", (4, 4), 330, 0, 32, 16, 2, 100, None),
    ("window_pad", (2, 2), 460, 5, 32, 16, 2, 150, (37, 0)),
]


@pytest.mark.parametrize("name,bits,prompt,steps,vf,t1,r,sw,pads", CASES,
                         ids=[c[0] for c in CASES])
def test_extend_plain_matches_pallas_interpret(name, bits, prompt, steps,
                                               vf, t1, r, sw, pads):
    jc = _cache(bits, prompt, steps, vf, sum(map(ord, name)))
    nkq, nkw, nvq = int(jc.n_k_quant), int(jc.n_k_win), int(jc.n_v_quant)
    assert flash_extend_full_supported(TMAX, W, t1, r, 32)
    rng = np.random.default_rng(len(name))
    qg = _bf16(rng, (B, H, r * t1, D))
    kn, vn = _bf16(rng, (B, H, t1, D)), _bf16(rng, (B, H, t1, D))
    pad = None if pads is None else np.asarray(pads, np.int32)
    kw = dict(group_size=32, k_bits=bits[0], v_bits=bits[1], t1=t1,
              sliding_window=sw)
    j = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want = j_full(j(qg), jc.k_codes, jc.k_scale, jc.k_mn, jc.v_codes,
                  jc.v_scale, jc.v_mn, jc.k_win, jc.v_win, j(kn), j(vn),
                  jc.n_k_quant, jc.n_k_win, jc.n_v_quant, jc.seq_len,
                  pad_len=None if pad is None else jnp.asarray(pad), **kw)
    tc = KiviLayerCache(**{f: _t(getattr(jc, f)) for f in (
        "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
        "k_win", "v_win")}, n_k_quant=nkq, n_k_win=nkw, n_v_quant=nvq,
        n_v_win=int(jc.n_v_win))
    got = flash_extend_attention(
        qg, tc.k_codes, tc.k_scale, tc.k_mn, tc.v_codes, tc.v_scale,
        tc.v_mn, tc.k_win, tc.v_win, kn, vn, nkq, nkw, nvq,
        pad_len=None if pad is None else torch.from_numpy(pad), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, H, r * t1, D)
    TOL.check_rows(got, torch.from_numpy(np.array(want)), TOL.EXTEND_RTOL,
                   f"{name} (nkq={nkq} nkw={nkw} nvq={nvq})")
