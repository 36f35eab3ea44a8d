"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests see 1 device;
only launch/dryrun.py (and subprocess tests) request 512 placeholders."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # benchmarks/

try:  # property tests prefer real hypothesis; fall back to the local stub
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    _hypothesis_stub.install(sys.modules)

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one "
        "(run with: pytest -m gpu tests/test_torch_gpu.py)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
