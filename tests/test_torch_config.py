"""The port's own copy of the configuration (kivi_tpu_torch.config) against
kivi_tpu.config: the same presets, defaults, derived values and
validation, so both packages are driven by identical knobs.

Tolerance: none - every field equal, every invalid config refused by both.
"""

import dataclasses

import pytest

from kivi_tpu import config as J
from kivi_tpu_torch import config as T


@pytest.mark.parametrize("name", sorted(J.PRESETS))
def test_presets_match_jax(name):
    assert sorted(T.PRESETS) == sorted(J.PRESETS)
    assert dataclasses.asdict(T.PRESETS[name]) == \
        dataclasses.asdict(J.PRESETS[name])
    assert T.PRESETS[name].num_query_groups == \
        J.PRESETS[name].num_query_groups


def test_defaults_and_tiny_config_match_jax():
    assert dataclasses.asdict(T.QuantConfig()) == \
        dataclasses.asdict(J.QuantConfig())
    assert dataclasses.asdict(T.tiny_config()) == \
        dataclasses.asdict(J.tiny_config())
    over = dict(head_dim=64, sliding_window=96, num_kv_heads=4)
    assert dataclasses.asdict(T.tiny_config(**over)) == \
        dataclasses.asdict(J.tiny_config(**over))


@pytest.mark.parametrize("kw", [
    dict(k_bits=3), dict(k_bits=16, v_bits=2), dict(residual_length=100),
    dict(v_flush=48), dict(v_flush=256), dict(k_bits=16, v_bits=16),
    dict(k_bits=8, v_bits=4, v_flush=64), dict(group_size=64)])
def test_quant_config_validation_matches_jax(kw):
    try:
        want = J.QuantConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            T.QuantConfig(**kw)
        return
    got = T.QuantConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.value_flush, got.quantize_kv) == \
        (want.value_flush, want.quantize_kv)
