"""Build, load and launch the package's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared
library of its own with a plain C interface, at first use, into the
package's ``_build/`` directory. The library's name is keyed by a hash of
the flags, the source and every header in ``csrc/``, so a stale build is
never loaded. :func:`build_all` compiles every library at once, one
``nvcc`` process per source.

Every exported function returns ``cudaGetLastError()`` after its launch;
:meth:`KernelLibrary.launch` raises on a nonzero code and otherwise adds
one to the kernel's entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from .. import config

#: Launches per kernel name since import (:func:`reset_launches` zeroes
#: them to count a run).
LAUNCHES: dict[str, int] = {}

FLAGS = (
    *config.NVCC_ARCH,
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

#: Every library the package defines, in definition order.
LIBRARIES: list["KernelLibrary"] = []

P, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class KernelLibrary:
    """One ``csrc/`` source and the C functions it exports.

    Args:
        source: file name under ``csrc/``.
        functions: ``{C function name: ctypes argument types}``; each
            returns an int CUDA error code.
        kernels: the kernel names whose launches this library counts.
    """

    def __init__(self, source: str, functions: dict[str, list], kernels: tuple[str, ...]):
        self.source = config.CSRC_DIR / source
        self.functions = functions
        #: ``nvcc``'s report (``-Xptxas -v``: registers, spills) of the
        #: build this process made, or "" when it loaded an earlier build.
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        for kernel in kernels:
            LAUNCHES.setdefault(kernel, 0)
        LIBRARIES.append(self)

    def path(self):
        digest = hashlib.sha256(" ".join(FLAGS).encode())
        digest.update(self.source.read_bytes())
        for header in sorted(config.CSRC_DIR.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
        return config.BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def _compile(self):
        """Start ``nvcc`` unless the library is built: (process, output
        file) or None."""
        path = self.path()
        if path.exists():
            return None
        config.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [config.nvcc(), *FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp

    def _finish(self, started) -> ctypes.CDLL:
        path = self.path()
        if started is not None:
            proc, tmp = started
            output, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source.name} ({proc.returncode}):\n{output}"
                )
            self.build_log = output
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tio_error_string.argtypes = [ctypes.c_int]
        lib.tio_error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def build(self) -> ctypes.CDLL:
        """Compile (if needed) and load the library."""
        with self._lock:
            if self._lib is None:
                self._finish(self._compile())
            return self._lib

    def launch(self, kernel: str, function: str, *args) -> None:
        """Call ``function`` and count one launch of ``kernel``; raises if
        the launch was refused."""
        lib = self.build()
        err = getattr(lib, function)(*args)
        if err != 0:
            raise RuntimeError(
                f"{kernel} kernel launch failed: {lib.tio_error_string(err).decode()}"
            )
        LAUNCHES[kernel] += 1


def build_all() -> list[KernelLibrary]:
    """Compile every library not built yet, all ``nvcc`` processes at
    once, then load them all. Returns the libraries."""
    from . import bspline_kernel, resample_kernel  # noqa: F401  (they register)

    pending = []
    for library in LIBRARIES:
        with library._lock:
            if library._lib is None:
                pending.append((library, library._compile()))
    errors = []
    for library, proc in pending:
        with library._lock:
            try:
                library._finish(proc)
            except RuntimeError as error:
                errors.append(str(error))
    if errors:
        raise RuntimeError("\n".join(errors))
    return list(LIBRARIES)


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def field_ratio(n_in: int, n_out: int) -> float:
    """Upsampling ratio of a coarse axis (align_corners)."""
    return 0.0 if n_out == 1 else (n_in - 1) / (n_out - 1)


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
