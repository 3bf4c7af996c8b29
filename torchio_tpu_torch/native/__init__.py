"""ctypes bindings of the host decode library (``fastnifti.cpp``).

The library is compiled by ``g++`` at first use, from the source beside
this file, into the package's ``_build/`` directory, as
``libfastnifti-<hash>.so``: the hash covers the compiler flags, the
source and the compiler's version, so a stale build is never loaded.
Three entry points are bound: ``gunzip`` (zlib inflate into a buffer of
the size the header gives),
``f2c_transpose`` (Fortran-order volume to C order, cache-blocked) and
``byteswap_inplace``. ctypes releases the interpreter lock while each
runs, so the Queue's worker threads decode in parallel.

Each entry point has a plain numpy version (``*_plain``), the reference
the tests hold the library to. When the library cannot be built or
loaded, :func:`available` is False, :func:`build_error` says why, and
each entry point warns (``RuntimeWarning``, with that error) before it
runs its plain version: a reader without a toolchain still reads, and
the loss is visible. :data:`CALLS` counts the calls each entry point
made into the library (under a lock: worker threads decode too).
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import io
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

from .. import config

SOURCE = Path(__file__).resolve().parent / "fastnifti.cpp"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

#: Calls into the library per entry point since import
#: (:func:`reset_calls` zeroes them to count a run).
CALLS: dict[str, int] = {"gunzip": 0, "f2c_transpose": 0, "byteswap": 0}
_calls_lock = threading.Lock()

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_calls() -> None:
    with _calls_lock:
        for name in CALLS:
            CALLS[name] = 0


def _count(name: str) -> None:
    with _calls_lock:
        CALLS[name] += 1


class FastNifti:
    """The library built into ``build_dir`` (the package's ``_build/``
    unless given), compiled and loaded at the first :meth:`get`."""

    def __init__(self, build_dir: Path | None = None):
        self.build_dir = Path(build_dir) if build_dir is not None else config.BUILD_DIR
        self.error: str | None = None
        self._lib: ctypes.CDLL | None = None
        self._tried = False
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(" ".join(FLAGS).encode())
        digest.update(SOURCE.read_bytes())
        digest.update(_compiler_version().encode())
        return self.build_dir / f"libfastnifti-{digest.hexdigest()[:16]}.so"

    def _compile(self, path: Path) -> None:
        compiler = shutil.which("g++")
        if compiler is None:
            raise OSError("g++ not found on PATH")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [compiler, *FLAGS, str(SOURCE), "-o", str(tmp), "-lz"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)  # noqa: S603
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise OSError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)

    def get(self) -> ctypes.CDLL | None:
        """The loaded library, building it first if needed; None (and
        :attr:`error` set) when that failed."""
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    path = self.path()
                    if not path.exists():
                        self._compile(path)
                    self._lib = _bind(ctypes.CDLL(str(path)))
                except (OSError, subprocess.SubprocessError) as error:
                    self.error = f"{type(error).__name__}: {error}"
            return self._lib


def _compiler_version() -> str:
    """``g++ --version``'s first line and the machine ("" without g++):
    a library another compiler built is not loaded."""
    compiler = shutil.which("g++")
    if compiler is None:
        return ""
    out = subprocess.run([compiler, "--version"], capture_output=True, text=True, timeout=60)  # noqa: S603
    return f"{out.stdout.splitlines()[0] if out.stdout else ''} {os.uname().machine}"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fn_gunzip.restype = I64
    lib.fn_gunzip.argtypes = [ctypes.c_char_p, I64, P, I64]
    lib.fn_f2c_transpose.restype = I32
    lib.fn_f2c_transpose.argtypes = [P, P, I64, I64, I64, I32]
    lib.fn_byteswap.restype = I32
    lib.fn_byteswap.argtypes = [P, I64, I32]
    return lib


#: The package's library (built into ``_build/``).
LIBRARY = FastNifti()


def available() -> bool:
    """Whether the package's library built and loaded."""
    return LIBRARY.get() is not None


def build_error() -> str | None:
    """Why the package's library is not available, or None."""
    LIBRARY.get()
    return LIBRARY.error


def _library(library: FastNifti | None, entry: str) -> ctypes.CDLL | None:
    library = LIBRARY if library is None else library
    lib = library.get()
    if lib is None:
        warnings.warn(
            f"native {entry} unavailable, running its numpy version: {library.error}",
            RuntimeWarning,
            stacklevel=3,
        )
    return lib


# --- plain versions -----------------------------------------------------


def gunzip_plain(data: bytes, expected_size: int) -> bytes:
    """Inflate a gzip stream with the standard library."""
    with gzip.GzipFile(fileobj=io.BytesIO(data)) as g:
        return g.read()


def f2c_transpose_plain(arr_f: np.ndarray) -> np.ndarray:
    """Any array to a contiguous C-order copy of it."""
    return np.ascontiguousarray(arr_f)


def byteswap_plain(arr: np.ndarray) -> np.ndarray:
    """A byte-swapped copy of ``arr`` (same dtype object)."""
    return arr.byteswap()


# --- entry points -------------------------------------------------------


def gunzip(data: bytes, expected_size: int, library: FastNifti | None = None):
    """Inflate a gzip stream into a buffer of ``expected_size`` bytes:
    returns a uint8 array of the bytes written (or the plain version's
    bytes when the library is missing, or refuses the stream: a
    concatenated or corrupt one gets the standard library's result or
    error)."""
    lib = _library(library, "gunzip")
    if lib is not None:
        out = np.empty(expected_size, np.uint8)
        written = lib.fn_gunzip(data, len(data), out.ctypes.data, expected_size)
        if written >= 0:
            _count("gunzip")
            return out[:written]
    return gunzip_plain(data, expected_size)


def f2c_transpose(arr_f: np.ndarray, library: FastNifti | None = None) -> np.ndarray:
    """(I, J, K) array of 1, 2, 4 or 8-byte items (any order, a memmap
    too) to a contiguous C-order copy."""
    if arr_f.ndim != 3 or arr_f.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"f2c_transpose takes a 3D array of 1-8 byte items, got {arr_f.shape}")
    lib = _library(library, "f2c_transpose")
    if lib is None:
        return f2c_transpose_plain(arr_f)
    src = np.asfortranarray(arr_f)
    dst = np.empty(arr_f.shape, dtype=arr_f.dtype, order="C")
    ni, nj, nk = arr_f.shape
    if lib.fn_f2c_transpose(src.ctypes.data, dst.ctypes.data, ni, nj, nk, arr_f.itemsize):
        raise RuntimeError(f"fn_f2c_transpose refused itemsize {arr_f.itemsize}")
    _count("f2c_transpose")
    return dst


def byteswap_inplace(arr: np.ndarray, library: FastNifti | None = None) -> np.ndarray:
    """Swap the bytes of a writable C-contiguous array of 2, 4 or 8-byte
    items in place (the dtype object is kept); returns it (the plain
    version's copy when the library is missing)."""
    if arr.itemsize not in (2, 4, 8) or not arr.flags.c_contiguous or not arr.flags.writeable:
        raise ValueError("byteswap_inplace takes a writable C-contiguous array of 2-8 byte items")
    lib = _library(library, "byteswap")
    if lib is None:
        return byteswap_plain(arr)
    if lib.fn_byteswap(arr.ctypes.data, arr.size, arr.itemsize):
        raise RuntimeError(f"fn_byteswap refused itemsize {arr.itemsize}")
    _count("byteswap")
    return arr
