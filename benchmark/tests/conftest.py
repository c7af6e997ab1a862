import pytest
import torch


@pytest.fixture
def card():
    """The test needs an NVIDIA card: skip here without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)
