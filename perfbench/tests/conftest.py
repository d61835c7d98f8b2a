"""Settings of the benchmark's own tests (``python -m pytest
perfbench/tests``): the ``gpu`` marker for tests that need a CUDA card,
which decide inside a fixture whether to skip."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def _threads():
    import torch

    torch.set_num_threads(2)
