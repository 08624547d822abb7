"""Pytest settings of the benchmark's own tests (run from the root of
the repository: ``python -m pytest portbench/tests``).  Tests that need
a CUDA card carry the ``cuda`` marker and decide inside a fixture
whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
