"""roofline.py against counts made by hand."""

import pytest

from kivi_tpu_torch.config import QuantConfig, tiny_config
from kvbench import roofline

Q = QuantConfig(2, 2, 32, 128, v_flush=128)


def test_kivi_bytes_by_hand():
    cfg = tiny_config(num_kv_heads=8, head_dim=128)
    # one quantized token a head: 128 codes at 2 bits (32 B) + a bf16
    # scale and zero point per 32 (16 B), for keys and for values
    assert roofline.kivi_bytes(cfg, Q, 32, 0, 32, 0) == 8 * 2 * 32 * 48
    # one window token a head: 128 keys and 128 values in bf16
    assert roofline.kivi_bytes(cfg, Q, 0, 1, 0, 1) == 8 * 2 * 256


def test_weight_bytes_mistral():
    from kivi_tpu_torch.config import PRESETS
    cfg = PRESETS["mistral-7b"]
    per_layer = (4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
                 + 2 * 4096)
    want = 2 * (32 * per_layer + 4096 + 4096 * 32000)
    assert roofline.weight_bytes(cfg) == want
    # 7.24e9 parameters less the embedding, whose rows a forward gathers
    assert 14.2e9 < want < 14.25e9


def test_decode_attention_shared_prefix_counted_once():
    cfg = tiny_config(num_heads=8, num_kv_heads=2, head_dim=32)
    rows = [(256, 10, 256, 10)] * 3
    f1, b1 = roofline.decode_attention(cfg, Q, rows)
    f2, b2 = roofline.decode_attention(cfg, Q, rows, shared=(256, 256))
    assert f1 == f2 == 3 * 4 * 8 * 32 * 266
    assert b1 - b2 == 2 * roofline.kivi_bytes(cfg, Q, 256, 0, 256, 0)
    # queries and outputs in bf16
    assert b2 == (roofline.kivi_bytes(cfg, Q, 256, 0, 256, 0)
                  + 3 * roofline.kivi_bytes(cfg, Q, 0, 10, 0, 10)
                  + 3 * 8 * 32 * 2 * 2)


def test_forward_prefill_by_hand():
    cfg = tiny_config()
    T = 100
    f, b = roofline.forward(cfg, Q, 1, T, logit_rows=1)
    L, Hq, D, Hd, V = 2, 4, 32, 128, 256
    gemm = 2 * T * L * roofline.layer_params(cfg) + 2 * Hd * V
    attn = 4 * Hq * D * L * T * (T + 1) / 2
    assert f == pytest.approx(gemm + attn)
    assert b == pytest.approx(roofline.weight_bytes(cfg)
                              + L * T * 2 * D * 2 * 2 + T * Hd * 2 + V * 4)


def test_bound_is_the_larger_time():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
