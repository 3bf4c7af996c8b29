"""Build settings for the package's CUDA kernels.

The kernels are compiled at first use, from the sources in ``csrc/``,
by ``nvcc`` into ``_build/`` inside the package (see
:mod:`torchio_tpu_torch.ops.resample_kernel`). Nothing here is read when
the package only runs on the CPU.
"""

from __future__ import annotations

import shutil
from pathlib import Path

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
