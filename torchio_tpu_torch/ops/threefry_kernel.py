"""Wrappers of the hand-written threefry kernel (``csrc/threefry.cu``).

``jax.random``'s draws on the card, element for element as the JAX
package draws them (the source file's head says what the kernel computes
and what bounds it):

- :func:`threefry_normal_cuda`: float32 standard normals, the draws of
  Noise and BiasField; its plain version is
  :func:`torchio_tpu_torch.random.normal_of_bits` of
  :func:`~torchio_tpu_torch.random.bits_plain`;
- :func:`threefry_bits_cuda`: the raw 32-bit words
  (``jax.random.bits``); its plain version is
  :func:`~torchio_tpu_torch.random.bits_plain`.

:mod:`.kernel_lib` builds and loads the library and counts the launches
(``LAUNCHES["threefry_normal"]``, ``LAUNCHES["threefry_bits"]``).
"""

from __future__ import annotations

import math

import torch

from .kernel_lib import I32, I64, P, U32, KernelLibrary, stream

THREEFRY = KernelLibrary(
    "threefry.cu",
    {"tio_threefry": [P, U32, U32, I64, I32, P]},
    kernels=("threefry_normal", "threefry_bits"),
)


def _draw(key, shape: tuple[int, ...], device: torch.device, normal: bool) -> torch.Tensor:
    if device.type != "cuda":
        raise ValueError(f"the threefry kernel runs on a CUDA device, got {device}")
    k0, k1 = (int(k) for k in key)
    if not (0 <= k0 <= 0xFFFFFFFF and 0 <= k1 <= 0xFFFFFFFF):
        raise ValueError(f"a key is two 32-bit words, got {key}")
    dtype = torch.float32 if normal else torch.int32
    out = torch.empty(shape, dtype=dtype, device=device)
    n = math.prod(shape)
    if n:
        with torch.cuda.device(device):
            THREEFRY.launch(
                "threefry_normal" if normal else "threefry_bits", "tio_threefry",
                out.data_ptr(), k0, k1, n, int(normal), stream(device),
            )
    return out


def threefry_normal_cuda(key, shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on a CUDA device."""
    return _draw(key, tuple(shape), torch.device(device), True)


def threefry_bits_cuda(key, shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) on a CUDA device."""
    return _draw(key, tuple(shape), torch.device(device), False).view(torch.uint32)
