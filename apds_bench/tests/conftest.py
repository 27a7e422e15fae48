"""The benchmark's own tests: CPU tests at toy sizes, and tests marked
`cuda` that need the card (they skip without one; the decision is made
inside a fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")
