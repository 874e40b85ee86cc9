"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository's root.  Those that need a CUDA card carry the ``cuda``
marker and skip, from their fixture, where there is none."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the server processes' engines "
        "on it)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the run's engines need one")
    return torch.cuda.get_device_name(0)
