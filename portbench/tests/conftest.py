"""The benchmark's own tests (run with ``python -m pytest portbench/tests``):
the plain reference, the data-driven layout, the roofline's yardstick, the
import guard, and the control and faults at a small size on the CPU. Tests
marked ``card`` need a CUDA device and skip without one; whether there is
one is decided inside the ``card`` fixture, never while a module is
imported."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
