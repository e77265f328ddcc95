"""pytest settings of the benchmark's own tests (benchmark/tests/).

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m card    # the card's tests, on a CUDA device

Tests marked `card` need a CUDA device; the `card` fixture decides at run
time, never at import, and skips them here with the reason."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an NVIDIA H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `-m card`")
    return torch.device("cuda")
