"""Pytest settings of the benchmark's own tests (`python -m pytest vobench`).

Tests that need a CUDA card carry the `card` marker and take the
`cuda_device` fixture, which decides inside the test whether a card is
present and skips with a reason where there is none.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control runs on the card")
    return torch.device("cuda", 0)
