"""Tests of the benchmark.  CPU tests run anywhere; tests marked ``cuda``
need a card and skip without one (decided inside a fixture, never while
a module is imported)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("cuda") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
