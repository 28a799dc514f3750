"""The benchmark's tests: ``python -m pytest gpubench/tests``.  Tests that
need the card take the ``card`` fixture, which skips without one."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's kernels and embedded "
                    "monitor have no CPU mode")
    return torch.device("cuda", 0)
