"""The benchmark's own tests (CPU, small sizes).  Run from the repository
root: `python -m pytest benchmark/tests -q`.  Tests marked `card` need a
CUDA device and skip without one (decided in the `card` fixture, at run
time); on the chip: `python -m pytest benchmark/tests -q -m card`."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
    import torch

    torch.set_num_threads(2)        # several workers share the machine


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path):
    from tiny import tiny_checkout

    return tiny_checkout(tmp_path)
