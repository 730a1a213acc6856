"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see 1 device;
multi-device tests spawn subprocesses (tests/test_distributed.py) or use the
devices the environment provides."""

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and the CUDA toolkit (skips, with its reason, elsewhere)",
    )
