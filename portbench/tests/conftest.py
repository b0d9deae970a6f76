"""Fixtures of the benchmark's own tests."""
import pytest

import smallcfg  # noqa: F401  (puts the harness and the program on the path)
from harness import manifest


@pytest.fixture
def bench():
    return manifest.load()


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)
