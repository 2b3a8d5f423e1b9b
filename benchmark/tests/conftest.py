"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository (the CPU tests), and on the card ``python -m pytest
benchmark/tests -q -m cuda``. A card test takes the ``cuda_card`` fixture,
which skips where there is none."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.cuda.get_device_name(0)
