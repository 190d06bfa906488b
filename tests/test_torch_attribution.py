"""Row 4's ablations (`fused_decode_attention_wide(_ablate=...)`) and the
attribution driver (kivi_tpu_torch.profile_attribution), on the CPU.

  * window, chunk and vquant: the JAX branches compute defined functions
    (kivi_tpu/kernels/fused_decode_wide.py:77-86), and the port's plain
    version computes the same ones.  Held against the JAX kernel in
    interpret mode on a cache made by the JAX package (T 1024, W 256,
    v_flush 128, so the value strip [n_v_quant, n_k_quant) can span
    chunks, as tests/test_fused_decode.py:123 builds it): at the JAX
    kernel's compute_dtype float32 within 1e-5 * max|out| + 1e-5 (the
    same f32 function; measured <= 1.3e-6), and at its default bf16
    within 5e-2 * max|out| (the JAX kernel rounds the query, the
    probabilities and the values to bf16: 3.0% of max|out| measured on
    the full function, the ablations at or below it).
  * the name-to-variant table, beside the JAX driver's names and the
    probe's variants 5 and 6, which qk and kunpack run with the windows
    live (exactly: trimmed_plain at an empty window);
  * `check` (what --check runs) on the CPU at a tiny geometry, where
    both sides are plain versions.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache.kivi_cache import (decode_append, init_layer_cache,
                                       prefill_ingest)
from kivi_tpu.config import QuantConfig
from kivi_tpu.kernels.fused_decode_wide import \
    fused_decode_attention_wide as jax_wide
from kivi_tpu_torch import profile_attribution as PA
from kivi_tpu_torch.kernels import fused_decode_wide as FD
from kivi_tpu_torch.kernels import trimmed as TR

torch.set_num_threads(2)

B, H, D, T, GS = 1, 2, 128, 1024, 32
QCFG = QuantConfig(k_bits=2, v_bits=2, group_size=GS, residual_length=256,
                   v_flush=128)
_SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
           / "attribution_r5.py")


@functools.lru_cache(maxsize=1)
def _driver():
    """The JAX attribution driver, loaded as a module (main() not run)."""
    spec = importlib.util.spec_from_file_location("attribution_r5", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _cache(tprompt: int, steps: int, seed: int = 0):
    """A JAX cache after a prompt and `steps` decode appends
    (tests/test_fused_decode.py:_mk_cache)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    cache = init_layer_cache(B, H, D, T, QCFG)
    k = jax.random.normal(ks[0], (B, H, tprompt, D), jnp.float32)
    v = jax.random.normal(ks[1], (B, H, tprompt, D), jnp.float32)
    cache = prefill_ingest(cache, k, v, QCFG)
    step = jax.jit(lambda c, kn, vn: decode_append(c, kn, vn, QCFG))
    for i in range(steps):
        kn = jax.random.normal(jax.random.fold_in(ks[2], i), (B, H, 1, D),
                               jnp.float32)
        vn = jax.random.normal(jax.random.fold_in(ks[3], i), (B, H, 1, D),
                               jnp.float32)
        cache = step(cache, kn, vn)
    return cache


ARRAYS = ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
          "k_win", "v_win")


# (prompt, decode steps, r): the strip [nvq, nkq) across the chunk edge
# at 512, decode across flushes, MHA rows with the strip on both sides
STATES = [(640, 0, 1), (640, 90, 4), (520, 250, 1)]


@pytest.mark.parametrize("ablate", [None, "window", "chunk", "vquant"])
@pytest.mark.parametrize("tprompt,steps,r,cdt", [
    s + ("float32",) for s in STATES] + [STATES[1] + ("bfloat16",)])
def test_plain_matches_the_jax_ablation(tprompt, steps, r, cdt, ablate):
    cache = _cache(tprompt, steps)
    counts = tuple(int(getattr(cache, n))
                   for n in ("n_k_quant", "n_k_win", "n_v_quant"))
    if ablate is None and steps == 0:
        assert counts[2] < counts[0]        # a live strip
    q = jax.random.normal(jax.random.PRNGKey(11), (B, H, r, D),
                          jnp.float32).astype(jnp.bfloat16)
    arrays = [getattr(cache, n) for n in ARRAYS]
    want = np.asarray(jax_wide(
        q.astype(jnp.float32), *arrays, *(jnp.int32(c) for c in counts),
        group_size=GS, k_bits=2, v_bits=2, _ablate=ablate,
        compute_dtype=getattr(jnp, cdt)))
    got = FD.fused_decode_attention_wide_plain(
        _t(q), *(_t(a) for a in arrays), *counts, group_size=GS, k_bits=2,
        v_bits=2, _ablate=ablate)
    assert got.shape == (B, H, r, D) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(want).all()
    tol = (dict(rtol=1e-5, atol=1e-5 * scale + 1e-5) if cdt == "float32"
           else dict(rtol=0, atol=5e-2 * scale))
    np.testing.assert_allclose(got.numpy(), want, **tol)
    if ablate is not None:          # the ablation changes the function
        full = FD.fused_decode_attention_wide_plain(
            _t(q), *(_t(a) for a in arrays), *counts, group_size=GS,
            k_bits=2, v_bits=2)
        assert (got - full).abs().max() > 0.1 * scale


def test_name_to_variant_table():
    assert FD.ABLATIONS == {"window": 8, "chunk": 9, "vquant": 10,
                            "qk": 5, "kunpack": 6, "compute": 11}
    assert tuple(PA.ABLATIONS) == tuple(_driver().ABLATIONS)
    assert set(FD.ABLATIONS) == set(_driver().ABLATIONS) - {"full"}
    # qk and kunpack are the probe's variants 5 and 6 (kernels/trimmed.py)
    assert TR.VARIANTS[("element", False, True, True)] == FD.ABLATIONS["qk"]
    assert TR.VARIANTS[("element", True, True, False)] == \
        FD.ABLATIONS["kunpack"]
    q = torch.zeros((1, 1, 1, 8))
    with pytest.raises(ValueError, match="_ablate"):
        FD.fused_decode_attention_wide(q, *([q] * 8), 0, 0, 0,
                                       group_size=8, k_bits=2, v_bits=2,
                                       _ablate="nope")


def _port_inputs(seed=3, fill=1000):
    from kivi_tpu_torch import profile_wide_32k as PW
    qg, c = PW.make_cache(B, T, fill, heads=H, seed=seed, device="cpu",
                          data="normal")
    return qg, c, PW._stores(c, T)


@pytest.mark.parametrize("ablate,key", [
    ("qk", ("element", False, True, True)),
    ("kunpack", ("element", True, True, False)),
    ("window", ("element", True, True, True))])
@pytest.mark.parametrize("fill", [300, 1000])
def test_windowless_ablations_equal_the_probe(ablate, key, fill):
    """At an empty window and n_v_quant = n_k_quant the wide ablations
    qk and kunpack compute the probe's variants 5 and 6, and window the
    full probe (trimmed_plain, the plain version of kernels/trimmed.py)."""
    qg, c, stores = _port_inputs(fill=fill)
    kw = dict(zip(("scales", "do_qk", "do_vpath", "do_unpack"), key))
    want = TR.trimmed_plain(qg, *stores, fill, group_size=GS, k_bits=2,
                            v_bits=2, **kw)
    got = FD.fused_decode_attention_wide_plain(
        qg, *stores, c.k_win, c.v_win, fill, 0, fill, group_size=GS,
        k_bits=2, v_bits=2, _ablate=ablate)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_compute_and_empty_ablations_give_zeros():
    qg, c, stores = _port_inputs()
    for ablate, counts in (("compute", (1000, 24, 1000)),
                           ("chunk", (1000, 0, 1000)),
                           ("window", (0, 100, 0))):
        out = FD.fused_decode_attention_wide_plain(
            qg, *stores, c.k_win, c.v_win, *counts, group_size=GS,
            k_bits=2, v_bits=2, _ablate=ablate)
        assert torch.equal(out, torch.zeros_like(out)), ablate


def test_check_runs_on_the_cpu():
    """`check` at a tiny geometry on the CPU: every variant through the
    wrapper (the plain version there) against the plain version, at each
    of CHECK_STATES, both data kinds."""
    assert PA.check(B=1, heads=2, device="cpu", verbose=False) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            PA.main(["--check"])


def test_hold_row_on_the_cpu_and_its_refusal(monkeypatch):
    """`hold_row` (what `profile` runs on a row's cache before timing it)
    at a row cut to T 1024 on the CPU, where both sides are plain
    versions; a wrapper that departs from its plain version is refused."""
    assert PA.hold_row(1024, 896, 1, device="cpu", verbose=False) == 0.0
    plain = FD.fused_decode_attention_wide_plain
    monkeypatch.setattr(FD, "fused_decode_attention_wide",
                        lambda *a, **kw: plain(*a, **kw) + 1e-2)
    with pytest.raises(AssertionError, match=r"full T=1024 fill=896"):
        PA.hold_row(1024, 896, 1, device="cpu", verbose=False)
