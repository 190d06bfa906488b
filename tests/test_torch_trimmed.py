"""The port's decode ablation probe (`kivi_tpu_torch.kernels.trimmed`,
CPU: the plain version) against the JAX probe `trimmed` of
`scripts/profile_wide_32k.py` in interpret mode, and its attention
variants against the JAX package's dequantize-then-softmax math and the
port's plain decode.

Inputs are made from a seed with numpy and quantized by the JAX
package; the port reads the same bits (uint32 words as int32) and the
same bf16 scales.  The JAX probe takes its K scales as (B, H, D, T//gs),
the transpose of the cache's rows: only its side is transposed.

Tolerances:
  * `do_vpath=False` against the JAX probe: 5e-3 * max|out|.  The probe
    rounds q and the scaled codes to bf16 before its QK product; the
    plain version computes in f32 from the same bf16 inputs.
  * the attention variants against f32 references: atol = rtol = 1e-5,
    the same math summed in another order.
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.core import quant as JQ
from kivi_tpu_torch.kernels import trimmed as TR
from kivi_tpu_torch.kernels.fused_decode_wide import \
    fused_decode_attention_wide_plain

torch.set_num_threads(2)

B, H, D, T, GS, C = 1, 2, 128, 1024, 32, 512
TOL = dict(atol=1e-5, rtol=1e-5)
FILLS = (600, 1000)
_SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
           / "profile_wide_32k.py")


@functools.lru_cache(maxsize=1)
def _probe():
    """The JAX probe script, loaded as a module (its main() is not run)."""
    spec = importlib.util.spec_from_file_location("profile_wide_32k",
                                                  _SCRIPT)
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


@functools.lru_cache(maxsize=16)
def _inputs(bits: int, r: int, kind: str = "quantized"):
    """JAX arrays (q bf16, the stores with bf16 scales) and the port's
    tensors of the same bits.  kind "quantized": normal K/V quantized by
    the JAX package; "probe": what the JAX probe's main() feeds it,
    random words and scales and minima uniform in [0.01, 0.1)."""
    rng = np.random.default_rng(100 * bits + r)
    q = jnp.asarray(rng.standard_normal((B, H, r, D)).astype(np.float32),
                    jnp.bfloat16)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    if kind == "quantized":
        k = rng.standard_normal((B, H, T, D)).astype(np.float32)
        v = rng.standard_normal((B, H, T, D)).astype(np.float32)
        kc, ks, km = JQ.quantize_k_block(
            jnp.swapaxes(jnp.asarray(k), -1, -2), GS, bits)
        vc, vs, vm = JQ.quantize_v_block(jnp.asarray(v), GS, bits)
    else:
        dw = D * bits // 32
        kc, vc = (jnp.asarray(rng.integers(0, 2 ** 32, (B, H, dw, T),
                                           dtype=np.uint32))
                  for _ in range(2))
        u = lambda *s: rng.uniform(0.01, 0.1, s).astype(np.float32)
        ks, km = u(B, H, T // GS, D), u(B, H, T // GS, D)
        vs, vm = u(B, H, D // GS, T), u(B, H, D // GS, T)
    jx = (q, kc, bf(ks), bf(km), vc, bf(vs), bf(vm))
    return jx, tuple(_t(x) for x in jx)


def _jax_trimmed(jx, fill, bits, **kw):
    q, kc, ks, km, vc, vs, vm = jx
    return np.asarray(_probe().trimmed(
        q.astype(jnp.float32), kc, jnp.swapaxes(ks, -1, -2),
        jnp.swapaxes(km, -1, -2), vc, vs, vm, jnp.int32(fill), gs=GS,
        k_bits=bits, v_bits=bits, C=C, Hg=H, **kw))


def _attention(jx, fill, bits):
    """softmax(q . dequant(K) / sqrt(D) over positions < fill) .
    dequant(V), by the JAX package's dequantizers, in numpy f32."""
    q, kc, ks, km, vc, vs, vm = jx
    kd = np.asarray(JQ.dequantize_k(kc, ks, km, GS, bits))      # (B,H,D,T)
    vd = np.asarray(JQ.dequantize_v(vc, vs, vm, GS, bits))      # (B,H,T,D)
    s = np.einsum("bhrd,bhdt->bhrt", np.asarray(q, np.float32), kd)
    s = s[..., :fill] / np.sqrt(D)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhrt,bhtd->bhrd", p, vd[:, :, :fill])


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("bits,r,expand", [
    (2, 1, "dot"), (2, 4, "dot"), (4, 1, "dot"), (4, 4, "dot"),
    (2, 1, "qfold"), (4, 1, "qfold")])   # the JAX qfold runs at r = 1 only
def test_vpath_off_matches_jax(bits, r, expand, fill):
    """With do_vpath=False both probes give the summed softmax
    probability of the chunk starts, a function of the true logits; on
    the JAX probe's own inputs (their logits spread by ~0.2, so its bf16
    rounding of the logits stays far below the tolerance)."""
    jx, tx = _inputs(bits, r, "probe")
    want = _jax_trimmed(jx, fill, bits, expand=expand, do_vpath=False)
    scales = "fold" if expand == "qfold" else "element"
    got = TR.trimmed_plain(*tx, fill, group_size=GS, k_bits=bits,
                           v_bits=bits, scales=scales, do_vpath=False,
                           chunk=C)
    assert got.shape == (B, H, r, D) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3 * scale)


@pytest.mark.parametrize("fill", FILLS + (T,))
@pytest.mark.parametrize("scales", ["element", "fold"])
@pytest.mark.parametrize("bits,r", [(2, 1), (2, 4), (4, 1), (4, 4)])
def test_attention_variants(bits, r, scales, fill):
    """The full and fold variants are attention over the quantized
    history: the JAX dequantizers + a softmax, and the port's plain
    decode with an empty window and n_k_quant = n_v_quant = fill."""
    jx, tx = _inputs(bits, r)
    got = TR.trimmed_plain(*tx, fill, group_size=GS, k_bits=bits,
                           v_bits=bits, scales=scales)
    np.testing.assert_allclose(got.numpy(), _attention(jx, fill, bits),
                               **TOL)
    win = torch.zeros((B, H, 32, D), dtype=torch.bfloat16)
    want = fused_decode_attention_wide_plain(
        *tx, win, win, fill, 0, fill, group_size=GS, k_bits=bits,
        v_bits=bits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_jax_full_variant_is_a_cost_model():
    """The JAX probe's full variant (expand="dot", every phase on) is not
    attention: its V path (scripts/profile_wide_32k.py:222-228) writes
    each plane's products into output columns [0, 2*VDw) of every row
    and adds the zero-point term to all D columns once per plane.  The
    port computes what that path models."""
    bits, fill = 2, 1000
    jx, tx = _inputs(bits, 1)
    att = _attention(jx, fill, bits)
    jax_full = _jax_trimmed(jx, fill, bits, expand="dot")
    port_full = TR.trimmed_plain(*tx, fill, group_size=GS, k_bits=bits,
                                 v_bits=bits).numpy()
    assert np.abs(jax_full - att).max() > 0.1
    assert np.abs(jax_full - att).max() > np.abs(att).max()
    np.testing.assert_allclose(port_full, att, **TOL)


def test_jax_probe_qfold_runs_at_r1_only():
    """The JAX probe's expand="qfold" builds one row per head
    (scripts/profile_wide_32k.py:141-146), Hg rows against Hg * r."""
    jx, _ = _inputs(2, 4, "probe")
    with pytest.raises(TypeError, match="incompatible shapes"):
        _jax_trimmed(jx, 1000, 2, expand="qfold", do_vpath=False)


def test_jax_probe_takes_the_stale_scale_layout():
    """Fed the cache's K scale rows (B, H, T//gs, D), as the production
    kernel and the cache store them, the JAX probe (which reads
    (B, H, D, T//gs)) does not compute the probe's function."""
    jx, _ = _inputs(2, 1, "probe")
    q, kc, ks, km, vc, vs, vm = jx
    rows = np.asarray(_probe().trimmed(
        q.astype(jnp.float32), kc, ks, km, vc, vs, vm, jnp.int32(1000),
        gs=GS, k_bits=2, v_bits=2, C=C, Hg=H, do_vpath=False))
    want = _jax_trimmed(jx, 1000, 2, do_vpath=False)
    assert not np.allclose(rows, want, rtol=0,
                           atol=5e-3 * np.abs(want).max())


def test_timing_variants_are_stated():
    """The timing-only variants, written out from their definitions
    (trimmed.VARIANTS), and the CPU wrapper = the plain version at the
    kernel's chunk of 128."""
    bits, fill = 2, 1000
    jx, tx = _inputs(bits, 1)
    q, kc, ks, km, vc, vs, vm = tx
    codes = TR.Q.unpack_codes(kc, bits, axis=-2).float()          # (B,H,D,T)
    low = (kc & 3).float()[:, :, (torch.arange(D) % 16) // 2]
    pos = torch.arange(T)
    sc = ks.float().transpose(-1, -2)[..., pos // GS]
    sc0 = ks.float().transpose(-1, -2)[..., (pos // 128 * 128) // GS]
    mn = km.float().transpose(-1, -2)[..., pos // GS]
    qf = q.float()
    vd = TR.Q.dequantize_v(vc, vs, vm, GS, bits)

    def attend(s, vpath=True):
        s = s[..., :fill] / np.sqrt(D)
        p = torch.softmax(s, dim=-1)
        if vpath:
            return p @ vd[:, :, :fill]
        return p[..., ::128].sum(-1, keepdim=True).expand(B, H, 1, D)

    qk = lambda kv: torch.einsum("bhrd,bhdt->bhrt", qf, kv)
    cases = {
        ("none", True, True, True): attend(qk(codes * sc0 + mn)),
        ("element", True, False, True): attend(qk(codes * sc + mn), False),
        ("fold", True, False, True): attend(qk(codes * sc + mn), False),
        ("element", False, True, True): attend(
            qk(mn) + (codes * sc).sum(2)[:, :, None]),
        ("element", True, True, False): attend(qk(low * sc + mn)),
        ("none", False, False, False): attend(
            qk(mn) + (low * sc0).sum(2)[:, :, None], False),
    }
    for (scales, do_qk, do_vpath, do_unpack), want in cases.items():
        kw = dict(group_size=GS, k_bits=bits, v_bits=bits, scales=scales,
                  do_qk=do_qk, do_vpath=do_vpath, do_unpack=do_unpack)
        got = TR.trimmed(*tx, fill, **kw)
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(
            got, TR.trimmed_plain(*tx, fill, chunk=128, **kw), rtol=0,
            atol=0)
    assert (TR.trimmed_plain(*tx, 0, group_size=GS, k_bits=bits,
                             v_bits=bits) == 0).all()
    with pytest.raises(ValueError, match="no variant"):
        TR.trimmed(*tx, fill, group_size=GS, k_bits=bits, v_bits=bits,
                   scales="fold", do_qk=False)


def test_profiler_runs_on_the_host(monkeypatch, capsys):
    """`python3 -m kivi_tpu_torch.profile_wide_32k` at a tiny size on the
    CPU, where every wrapper takes its plain version: the two anchors
    (the decode route is the split one at 32 blocks over a history past
    the lowered SPLIT_MIN_HISTORY) and every variant, each with its
    bound; and --check's comparisons.  Its CLI refuses to run without a
    card; the times here are the host's, not the card's."""
    from kivi_tpu_torch import profile_wide_32k as PW
    from kivi_tpu_torch.core import attention as TA
    monkeypatch.setattr(TA, "SPLIT_MIN_HISTORY", 256)
    calls = []
    monkeypatch.setattr(TA, "_decode_attention_split",
                        lambda *a, _f=TA._decode_attention_split:
                        calls.append(1) or _f(*a))
    rows = PW.profile(1, 512, 480, iters=1, smi="host CPU", device="cpu")
    assert [r["item"] for r in rows][:2] == [
        "wide kernel (fused_decode_attention_wide)",
        "decode route (split, core.attention)"]
    assert len(rows) == 2 + len(TR.VARIANTS) and calls
    assert all(r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    assert rows[-1]["item"] == ("trimmed scales=none, no QK, no V path, "
                                "no unpack")
    for data in PW.DATA:
        assert PW.check(*PW.make_cache(1, 512, 480, device="cpu",
                                       data=data)) >= 0.0
    out = capsys.readouterr().out
    assert out.count("[time]") == len(rows)
    assert out.count("[check]") == len(PW.DATA) * (len(TR.VARIANTS) + 4)
    assert "decode route (split)" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            PW.main(["--quick"])


@pytest.mark.parametrize("bits", [2, 4])
def test_normal_cache_peaks_the_softmax(bits):
    """The profiler's `make_cache(data="normal")`, the second cache its
    check (and chip_smoke.py) holds the kernels to: keys and values
    quantized by the port from N(0, 1), q scaled to a logit spread of
    Q_STD.  Its softmax is peaked, so attention that lost its QK term
    (the mean of V over the history) misses the card's tolerance by
    orders of magnitude, where on the uniform cache it misses by far
    less."""
    from kivi_tpu_torch import profile_wide_32k as PW
    from kivi_tpu_torch.core import quant as TQ
    fill, miss = 1000, {}
    for data in PW.DATA:
        qg, c = PW.make_cache(1, 1024, fill, heads=2, bits=bits, seed=3,
                              device="cpu", data=data)
        assert c.k_scale.dtype == c.v_mn.dtype == qg.dtype == torch.bfloat16
        stores = (c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale,
                  c.v_mn)
        # the card's wrappers take contiguous stores only
        assert all(t.is_contiguous() for t in stores + (c.k_win, qg))
        out = TR.trimmed_plain(qg, *stores, fill, group_size=GS,
                               k_bits=bits, v_bits=bits)
        flat = TQ.dequantize_v(c.v_codes, c.v_scale, c.v_mn, GS,
                               bits)[:, :, :fill].mean(dim=2, keepdim=True)
        tol = 1e-5 * out.abs().max().item() + 1e-5
        miss[data] = (out - flat).abs().max().item() / tol
    assert miss["normal"] > 1e4 and miss["normal"] > 10 * miss["uniform"]
