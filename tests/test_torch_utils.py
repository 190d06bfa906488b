"""The port's `utils.timing` and `utils.profiling` (CPU) against their
JAX counterparts `kivi_tpu.utils.timing` / `kivi_tpu.utils.profiling`:
the benchmark loop keeps its data dependence and returns a positive
time, and the cache-memory report equals the JAX one in every key."""

import pytest
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.utils import profiling as JP
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import PRESETS, QuantConfig, tiny_config
from kivi_tpu_torch.utils import profiling as P
from kivi_tpu_torch.utils import timing as TT

torch.set_num_threads(2)


def test_bench_loop_keeps_the_dependence():
    """Every step consumes the state the previous one returned, and each
    run starts again from init_state."""
    seen = []

    def step(state):
        x, n = state
        seen.append(int(n))
        return (x * 1.0001, n + 1)

    t = TT.bench_loop(step, (torch.ones(64), torch.tensor(0)), iters=6,
                      warmup_iters=2, repeats=2)
    assert t > 0
    # a warm run of 2, then 2 runs of 2 and 2 runs of 8, each from 0
    runs = [2, 2, 2, 8, 8]
    want = [i for n in runs for i in range(n)]
    assert seen == want


def test_bench_fn_feeds_the_output_back():
    calls = []

    def fn(x, w):
        calls.append(x.clone())
        return x @ w

    x, w = torch.ones(4, 4), torch.eye(4) * 1e29
    t = TT.bench_fn(fn, x, w, iters=3, repeats=1)
    assert t > 0
    # the output's sum (4 * 4e29) times 1e-30 is added to x after a call
    assert torch.equal(calls[0], x)
    torch.testing.assert_close(calls[1], x + 1.6)
    with pytest.raises(ValueError, match="no tensor"):
        TT.bench_loop(lambda s: s, 1.0)


def test_bound():
    assert TT.bound(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    assert TT.bound(0, 989e9) == pytest.approx((1.0, "operations"))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("batch,tmax", [(1, 512), (3, 256)])
def test_kv_cache_report_matches_jax(bits, batch, tmax):
    got = P.kv_cache_report(tiny_config(), QuantConfig(bits, bits, 32, 128),
                            batch, tmax)
    want = JP.kv_cache_report(j_tiny_config(),
                              JQuantConfig(bits, bits, 32, 128), batch, tmax)
    assert got == pytest.approx(want, rel=0, abs=0)
    assert got.keys() == want.keys()


def test_kv_cache_report_at_llama_width():
    """At a real width, with no allocation: Llama-3.1-8B, a 32K cache."""
    rep = P.kv_cache_report(PRESETS["llama3.1-8b"], QuantConfig(2, 2, 32, 32),
                            4, 32768)
    assert rep["fp16_bytes"] == 32 * 2 * 4 * 8 * 32768 * 128 * 2 + 32 * 4
    assert 5 < rep["memory_reduction"] < 6


def test_tensor_bytes():
    c = KC.init_layer_cache(2, 3, 64, 256, QuantConfig(2, 2, 32, 128),
                            device="cpu")
    want = sum(t.numel() * t.element_size() for t in (
        c.k_codes, c.k_scale, c.k_mn, c.v_codes, c.v_scale, c.v_mn,
        c.k_win, c.v_win))
    assert P.tensor_bytes(c) == want
    assert P.tensor_bytes({"a": [c, (torch.zeros(5),)], "n": 3}) == want + 20


def test_memory_snapshot_is_none_on_the_cpu():
    assert P.memory_snapshot("cpu") is None
    if not torch.cuda.is_available():
        assert P.memory_snapshot() is None

