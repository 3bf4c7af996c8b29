"""pytest settings of the benchmark's own tests (``port_bench/tests``).

Registers the ``card`` marker of tests that need a CUDA device; the
``card`` fixture decides inside each test whether there is one, so every
worker collects the same tests. Warms PyTorch's CPU thread pool once, as
``tests/cpu_warmup.py`` does for the repository's tests: on some CPU
builds the first multithreaded transcendental region of a process
returns wrong values."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.exp(torch.linspace(-3.0, 3.0, 1 << 20))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; runs on the card only")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.device("cuda:0")
