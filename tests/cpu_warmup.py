"""Warm PyTorch's CPU thread pool before a parity test compares anything.

On PyTorch 2.13.0+cpu the first multithreaded transcendental region of a
process (``torch.exp``, ``torch.sin``, ...) has returned values off by up
to 4.2e-4 in about a third of fresh processes; every later call is right.
Importing this module runs that first region on throwaway data, so every
test process (each pytest-xdist worker included) has passed it before its
first comparison at 1e-4 or 1e-5.
"""

from __future__ import annotations

import torch


def warm_cpu_threads() -> None:
    """One multithreaded ``torch.exp`` over 2^20 floats."""
    torch.exp(torch.linspace(-3.0, 3.0, 1 << 20))


warm_cpu_threads()
