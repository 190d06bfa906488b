"""The per-row tolerances of the tensor-core kernels (utils.tolerance).

The kernels themselves run only on the card (tests/test_torch_kernels_cuda
.py, chip_smoke.py).  Here their rounding is modelled on the CPU from the
plain versions' inputs (bf16 p with the running max of 128-key or 64-key
chunks, a bf16 output; for qhist and the full extend kernel bf16
K^ = code * scale with the zero point added in f32, and bf16 V^) and held
within half of each limit, and a control that drops one chunk of keys
must be refused.
"""

import math

import pytest
import torch

from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import QuantConfig
from kivi_tpu_torch.core import quant as Q
from kivi_tpu_torch.kernels import flash as FL
from kivi_tpu_torch.kernels import flash_extend as FE
from kivi_tpu_torch.utils import tolerance as TOL


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _online_p(s, valid, ck):
    """p as the kernels pass it to PV: exp(s - m_run) rounded to bf16,
    m_run the running max after each ck-key chunk, rescaled to the final
    max in f32; l from the unrounded p."""
    s = s.masked_fill(~valid, TOL.NEG_INF)
    m = s.amax(-1, keepdim=True)
    shape = s.shape[:-1] + (s.shape[-1] // ck, ck)
    run = torch.cummax(s.reshape(shape).amax(-1), -1).values
    run = run.repeat_interleave(ck, -1)
    p = torch.where(valid, torch.exp(s - run), 0.0)
    f = torch.exp(run - m)
    return _bf16(p) * f, (p * f).sum(-1), m[..., 0]


def _flash_model(q, k, v, valid):
    s = q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1])
    p, l, _ = _online_p(s, valid, 128)
    out = (p @ v.float()) / l.clamp_min(1e-30)[..., None]
    return _bf16(torch.where(valid.any(-1, keepdim=True), out, 0.0))


@pytest.mark.parametrize("sw,pad", [(None, None), (100, None),
                                    (None, (0, 37)), (300, (200, 511))])
def test_flash_rounding_within_half_the_limit(sw, pad):
    gen = torch.Generator().manual_seed(sw or 0)
    B, H, T, D = 2, 4, 512, 128
    q, k, v = (torch.randn(B, H, T, D, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    pad_len = None if pad is None else torch.tensor(pad)
    want = FL.flash_attention_plain(q, k, v, sliding_window=sw,
                                    pad_len=pad_len)
    pos = torch.arange(T)
    valid = (pos[None, :] <= pos[:, None]).expand(B, 1, T, T)
    if sw:
        valid = valid & (pos[None, :] > pos[:, None] - sw)
    if pad_len is not None:
        valid = valid & (pos >= pad_len.reshape(B, 1, 1, 1))
    _, share = TOL.check_rows(_flash_model(q, k, v, valid), want,
                              TOL.FLASH_RTOL, "flash model")
    assert share <= 0.5
    # control: the last 128 rows without their first 128-key chunk
    ctrl = want.clone()
    ctrl[:, :, -128:] = FL.flash_attention_plain(
        q, k, v, sliding_window=sw,
        pad_len=torch.full((B,), 128))[:, :, -128:]
    if sw is None or sw > T - 128:
        assert TOL.row_share(ctrl, want, TOL.FLASH_RTOL).max() > 1


def _qhist_case(bits, fill, r=4, t1=32, H=2, D=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    qcfg = QuantConfig(bits, bits, 32, 32, v_flush=32)
    c = KC.init_layer_cache(1, H, D, 4096, qcfg, device="cpu")
    KC.prefill_ingest(
        c, torch.randn(1, H, fill, D, generator=gen).to(torch.bfloat16),
        torch.randn(1, H, fill, D, generator=gen).to(torch.bfloat16), qcfg)
    qg = torch.randn(1, H, r * t1, D, generator=gen).to(torch.bfloat16)
    args = (qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.v_win, c.n_k_quant, c.n_v_quant, c.seq_len)
    kw = dict(group_size=32, k_bits=bits, v_bits=bits, t1=t1)
    return c, args, kw


def _qhist_model(c, qg, bits):
    """The kernel's state over the whole history (no pad, no window)."""
    nkq, nvq = c.n_k_quant, c.n_v_quant
    zero = torch.zeros_like(c.k_mn)
    k = _bf16(Q.dequantize_k(c.k_codes, c.k_scale, zero, 32, bits))
    k = k + Q.dequantize_k(c.k_codes * 0, c.k_scale, c.k_mn, 32, bits)
    v = _bf16(Q.dequantize_v(c.v_codes, c.v_scale, c.v_mn, 32, bits))
    v[:, :, nvq:nkq] = c.v_win[:, :, :nkq - nvq].float()
    s = qg.float() @ k[..., :nkq] / math.sqrt(qg.shape[-1])
    n = -(-nkq // 64) * 64                     # whole 64-position chunks
    s = torch.nn.functional.pad(s, (0, n - nkq))
    valid = torch.arange(n) < nkq
    p, l, m = _online_p(s, valid.expand(s.shape), 64)
    return p[..., :nkq] @ v[:, :, :nkq], m, l


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qhist_rounding_within_half_the_limit(bits):
    c, args, kw = _qhist_case(bits, 1500, seed=bits)
    want = FE.flash_extend_qhist_plain(*args, **kw)
    _, share, empty = TOL.check_state(_qhist_model(c, args[0], bits), want,
                                      TOL.QHIST_RTOL, f"qhist model {bits}")
    assert share <= 0.5 and empty == 0
    # control: the history without its first 64-position chunk
    ctrl = FE.flash_extend_qhist_plain(*args, **kw,
                                       pad_len=torch.tensor([64]))
    assert max(TOL.state_shares(ctrl, want, TOL.QHIST_RTOL).values()) > 1


def _extend_case(bits, fill, vf, r=2, t1=32, H=2, D=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    qcfg = QuantConfig(bits, bits, 32, 128, v_flush=vf)
    c = KC.init_layer_cache(2, H, D, 1024, qcfg, device="cpu")
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(torch.bfloat16)
    KC.prefill_ingest(c, rnd(2, H, fill, D), rnd(2, H, fill, D), qcfg)
    qg, kn, vn = rnd(2, H, r * t1, D), rnd(2, H, t1, D), rnd(2, H, t1, D)
    args = (qg, c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
            c.k_win, c.v_win, kn, vn, c.n_k_quant, c.n_k_win, c.n_v_quant)
    return c, args, dict(group_size=32, k_bits=bits, v_bits=bits, t1=t1)


def _extend_model(c, qg, kn, vn, bits, t1, sw, pad):
    """The full extend kernel's output: K^ = code * scale rounded to bf16
    with the zero point added in f32, V^ = code * scale + mn rounded to
    bf16 below n_v_quant, then the v_win rows up to T0 and the new rows;
    p rounded to bf16 with the running max of 64-position chunks."""
    nkq, nkw, nvq = c.n_k_quant, c.n_k_win, c.n_v_quant
    T0 = nkq + nkw
    B, H, R, D = qg.shape
    zero = torch.zeros_like(c.k_mn)
    k = _bf16(Q.dequantize_k(c.k_codes, c.k_scale, zero, 32, bits))
    k = k + Q.dequantize_k(c.k_codes * 0, c.k_scale, c.k_mn, 32, bits)
    k = torch.cat([k.transpose(-1, -2)[:, :, :nkq],
                   c.k_win[:, :, :nkw].float(), kn.float()], 2)
    v = _bf16(Q.dequantize_v(c.v_codes, c.v_scale, c.v_mn, 32, bits))
    v = torch.cat([v[:, :, :nvq], c.v_win[:, :, :T0 - nvq].float(),
                   vn.float()], 2)
    q5 = qg.float().reshape(B, H, R // t1, t1, D)
    s = q5 @ k[:, :, None].transpose(-1, -2) / math.sqrt(D)
    pos = torch.arange(T0 + t1)
    qpos = T0 + torch.arange(t1)[:, None]
    lo = torch.zeros((B, 1, 1, 1, 1), dtype=torch.long)
    if pad is not None:
        lo = pad.reshape(B, 1, 1, 1, 1)
    if sw:
        lo = torch.maximum(lo, qpos - (sw - 1))
    valid = (pos <= qpos) & ((pos >= lo) | (pos == qpos))
    n = -(-(T0 + t1) // 64) * 64               # whole 64-position chunks
    s = torch.nn.functional.pad(s, (0, n - T0 - t1))
    valid = torch.nn.functional.pad(valid.expand(s.shape[:-1] + (T0 + t1,)),
                                    (0, n - T0 - t1))
    p, l, _ = _online_p(s, valid, 64)
    out = p[..., :T0 + t1] @ v[:, :, None] / l[..., None]
    return out.reshape(B, H, R, D)


@pytest.mark.parametrize("bits,fill,vf,sw,pad", [
    (2, 500, 128, 0, None), (4, 200, 32, 0, (0, 37)),
    (8, 460, 32, 150, None), (2, 330, 32, 100, (64, 0)),
    (2, 100, 32, 0, (0, 200))])                 # rows padded past T0
def test_extend_rounding_within_half_the_limit(bits, fill, vf, sw, pad):
    c, args, kw = _extend_case(bits, fill, vf, seed=bits + fill)
    pad_len = None if pad is None else torch.tensor(pad)
    want = FE.flash_extend_attention_plain(*args, **kw, sliding_window=sw,
                                           pad_len=pad_len)
    model = _extend_model(c, args[0], args[9], args[10], bits, kw["t1"], sw,
                          pad_len)
    _, share = TOL.check_rows(model, want, TOL.EXTEND_RTOL,
                              f"extend model {bits} {fill}")
    assert share <= 0.5
    # control: the history without its first 64 positions
    if pad is None and not sw:
        ctrl = FE.flash_extend_attention_plain(*args, **kw,
                                               pad_len=torch.full((2,), 64))
        assert TOL.row_share(ctrl, want, TOL.EXTEND_RTOL).max() > 1


def test_check_state_empty_rows_exact():
    c, args, kw = _qhist_case(2, 300)
    pad = torch.tensor([400])                   # no row sees the history
    want = FE.flash_extend_qhist_plain(*args, **kw, pad_len=pad)
    assert TOL.check_state(want, want, TOL.QHIST_RTOL, "empty")[2] == \
        want[1].numel()
    acc, m, l = (t.clone() for t in want)
    l[0, 0, 0] = 1e-3                           # an empty row with mass
    with pytest.raises(AssertionError, match="empty rows"):
        TOL.check_state((acc, m, l), want, TOL.QHIST_RTOL, "empty")


def test_check_rows_holds_each_row_to_its_own_scale():
    want = torch.tensor([[4.0, -2.0], [0.05, 0.01]])
    # 1% of the small row: within 4 * 2^-8 of the whole tensor, not of
    # the row's own max
    got = want + torch.tensor([[0.0, 0.0], [0.01, 0.0]])
    with pytest.raises(AssertionError, match="row 1"):
        TOL.check_rows(got, want, TOL.FLASH_RTOL, "rows")
    assert TOL.check_rows(want, want, TOL.FLASH_RTOL, "rows")[1] == 0
    with pytest.raises(AssertionError, match="non-finite"):
        TOL.check_rows(want * float("nan"), want, TOL.FLASH_RTOL, "rows")
