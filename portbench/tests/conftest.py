"""Fixtures of the benchmark's tests."""

import pytest


@pytest.fixture
def card():
    """A test that needs the CUDA card skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
