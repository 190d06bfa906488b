"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark
(tiny.py) and the marker of the tests that need the card."""

import pytest

from kvbench.tests.tiny import make_root


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips "
                            "without one (decided in the `card` fixture)")


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))


@pytest.fixture
def deep_root(tmp_path):
    return make_root(str(tmp_path), deep=True)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")
