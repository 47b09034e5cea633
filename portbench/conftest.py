"""Fixtures of the benchmark's tests. Whether a card is present is decided
inside the `cuda_device` fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@pytest.fixture
def cuda_device():
    """"cuda" on a card; skips the test elsewhere."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return "cuda"
