"""Package settings: the default device of host data, and the build
settings of the CUDA kernels.

Host data (numpy arrays, lists) given to an image, a subject or a
transform lands on :func:`default_device`, ``cuda`` unless a caller asks
for another with :func:`set_default_device` (the CPU tests ask for
``cpu``); a tensor keeps the device its caller chose. Without a card and
without a request for the CPU, building an image from host data raises
PyTorch's own error: nothing falls back to the CPU quietly.

The kernels are compiled at first use, from the sources in ``csrc/``,
by ``nvcc`` into ``_build/`` inside the package (see
:mod:`torchio_tpu_torch.ops.kernel_lib`). None of the build settings is
read when the package only runs on the CPU.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

_default_device = torch.device("cuda")


def default_device() -> torch.device:
    """The device host data is placed on."""
    return _default_device


def set_default_device(device: str | torch.device) -> torch.device:
    """Place host data on ``device`` from now on; returns the previous
    default, so that a caller can restore it."""
    global _default_device
    previous = _default_device
    _default_device = torch.device(device)
    return previous


def as_tensor(x: Any) -> torch.Tensor:
    """A tensor as it is; numpy arrays and nested lists to a tensor on the
    default device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=_default_device)


PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: Hopper only: ``sm_90a`` keeps the architecture-specific features
#: (wgmma, setmaxnreg) that plain ``sm_90`` refuses.
NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then the toolkit's
    default location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
