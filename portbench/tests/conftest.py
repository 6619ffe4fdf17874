"""The benchmark's own tests: CPU at toy sizes, apart from those marked
``chip``, which run on a machine with a CUDA device and skip elsewhere.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
