"""Wrapper of the hand-written CUDA resample kernel (``csrc/resample.cu``).

The kernel stands in for the JAX package's Pallas resample kernels
(``ops/shear_resample.py`` and ``ops/window_resample.py``); the source
file's head says what it computes and what bounds it. Its plain PyTorch
version is :func:`torchio_tpu_torch.ops.resample.resample_plain`, which
takes the same arguments.

The shared library is built at first use with ``nvcc`` into the
package's ``_build/`` directory, under a name keyed by a hash of the
source and the flags, so a stale build is never loaded. It has a plain C
interface and is loaded with ``ctypes``. A launch goes on the current
CUDA stream and adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from .. import config

#: Number of kernel launches since import (reset it to count a run).
LAUNCHES = 0

#: ``nvcc``'s report (``-Xptxas -v``: registers, spills) of the last build
#: made by this process, or "" when the library was already built.
BUILD_LOG = ""

SOURCE = config.CSRC_DIR / "resample.cu"
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

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path():
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return config.BUILD_DIR / f"libtio_resample-{digest.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            config.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [config.nvcc(), *FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            BUILD_LOG = proc.stdout + proc.stderr
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tio_resample.argtypes = [p, p, p, p, p] + [i] * 11 + [f] * 3 + [i, i, p]
        lib.tio_resample.restype = ctypes.c_int
        lib.tio_error_string.argtypes = [ctypes.c_int]
        lib.tio_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _ratio(n_in: int, n_out: int) -> float:
    return 0.0 if n_out == 1 else (n_in - 1) / (n_out - 1)


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def resample_cuda(
    vol: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    fill: torch.Tensor,
    out_shape: tuple[int, int, int],
    mode: str,
    apply_fill: bool,
) -> torch.Tensor:
    """Resample on the card; see :func:`..resample.resample_plain` for
    the arguments. Returns a new (B, C, Io, Jo, Ko) float32 tensor."""
    global LAUNCHES
    if vol.device.type != "cuda":
        raise ValueError(f"resample_cuda needs a CUDA tensor, got {vol.device}")
    if vol.ndim != 5:
        raise ValueError(f"vol must be (B, C, I, J, K), got {tuple(vol.shape)}")
    if mode not in ("linear", "nearest"):
        raise ValueError(f"Unsupported resampling mode: {mode!r}")
    b, c, si, sj, sk = vol.shape
    io, jo, ko = (int(s) for s in out_shape)
    if min(io, jo, ko) < 1:
        raise ValueError(f"out_shape must be positive, got {out_shape}")
    if max(b, c, si, sj, sk, io, jo, ko) >= 2**31:
        raise ValueError("every dimension must be below 2**31")
    dev = vol.device
    _check("vol", vol, tuple(vol.shape), dev)
    _check("maps", maps, (b, 3, 4), dev)
    _check("fill", fill, (b, c), dev)
    ni = nj = nk = 0
    if fields is not None:
        if fields.ndim != 5 or fields.shape[0] != b or fields.shape[-1] != 3:
            raise ValueError(f"fields must be (B, ni, nj, nk, 3), got {tuple(fields.shape)}")
        ni, nj, nk = (int(n) for n in fields.shape[1:4])
        _check("fields", fields, (b, ni, nj, nk, 3), dev)
    out = torch.empty((b, c, io, jo, ko), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(dev):
        err = lib.tio_resample(
            vol.data_ptr(), maps.data_ptr(),
            None if fields is None else fields.data_ptr(),
            fill.data_ptr(), out.data_ptr(),
            b, c, si, sj, sk, io, jo, ko, ni, nj, nk,
            _ratio(ni, io), _ratio(nj, jo), _ratio(nk, ko),
            int(mode == "nearest"), int(apply_fill),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"resample kernel launch failed: {lib.tio_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return out
