"""The benchmark's CPU tests.  Run them from the root of the repository:

    python -m pytest portbench/tests -q

A test that needs the card takes the ``cuda_device`` fixture, which skips
it where no card is visible.
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card "
                    "and its CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)
