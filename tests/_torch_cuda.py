"""The ``cuda`` fixture of the ``tests/test_torch_*.py`` files.

Tests that need an NVIDIA GPU carry ``@pytest.mark.cuda`` and take this
fixture, which skips them, with the reason, where ``torch.cuda`` finds no
device. The decision is made when the test runs, never at import, so every
test worker collects the same tests.
"""
import pytest
import torch


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")
