"""The benchmark's own tests (not collected by the repository's suite):

    python -m pytest benchmark/tests -q

Tests that need the card take the ``card`` fixture, which skips them
without one; on the chip they run with the rest.
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return "cuda"
