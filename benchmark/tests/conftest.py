"""Tests of the benchmark under `benchmark/`: run from the root of the
checkout with `python -m pytest benchmark/tests -q`. Tests that need the
card carry the `cuda` marker and skip inside the `cuda_device` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
