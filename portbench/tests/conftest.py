"""Tests of the benchmark's harness. Run from the repository's root:

    python -m pytest portbench/tests -q

Tests marked ``card`` need an NVIDIA card and skip without one; on the
card they run with the rest (``python3 -m pytest portbench/tests -q``).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card's device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
