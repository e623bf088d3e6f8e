"""Settings of the benchmark's own tests: the ``card`` marker, and the
``card`` fixture that skips a test where no CUDA device is visible (decided
inside the test, never while a module is imported)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (run on the card: python3 -m "
        "pytest perfbench/tests -m card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this host has none")
    return torch.device("cuda")
