"""jax.random's threefry2x32 normals in plain PyTorch integer and float32
ops: the keys of a recorded seed and the normals of a flat draw, element
for element.

A frozen copy of the plain draws of ``torchio_tpu_torch/random.py`` at
commit fe6a028 (``prng_key``, ``key_injections``, ``threefry2x32``,
``split``, ``draw_key``, ``bits_plain``, ``uniform_of_bits``, ``erf_inv``,
``normal_of_bits``), with nothing of the program imported."""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KEY_PARITY = 0x1BD11BDA
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
NORMAL_HI = 1.0
SQRT2 = float(np.float32(np.sqrt(2.0)))
ERFINV_W_LT_5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_W_GE_5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off."""
    return (0, int(seed) & MASK32)


def key_injections(key) -> tuple[int, ...]:
    ks = (key[0], key[1], key[0] ^ key[1] ^ KEY_PARITY)
    return tuple(
        w for g in range(5) for w in (ks[(g + 1) % 3], (ks[(g + 2) % 3] + g + 1) & MASK32)
    )


def threefry2x32(key, x0, x1):
    """The block of the counter pairs ``(x0, x1)`` under ``key`` (Python
    ints or int64 tensors of 32-bit words)."""
    inject = key_injections(key)
    x0 = (x0 + key[0]) & MASK32
    x1 = (x1 + key[1]) & MASK32
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x1 ^ x0
        x0 = (x0 + inject[2 * group]) & MASK32
        x1 = (x1 + inject[2 * group + 1]) & MASK32
    return x0, x1


def split(key, num: int = 2):
    return [threefry2x32(key, 0, i) for i in range(num)]


def draw_key(seed: int, index: int):
    """Key of draw ``index`` of a recorded seed: 0 is ``PRNGKey(seed)``
    (BiasField); Noise's image ``n`` takes ``2n + 1`` (and ``2n + 2`` for
    a second Rician field), from ``n + 1`` three-way splits."""
    key = prng_key(seed)
    if index > 0:
        for _ in range((index - 1) // 2 + 1):
            key, k1, k2 = split(key, 3)
        key = k1 if index % 2 == 1 else k2
    return key


def bits(key, start: int, count: int, device) -> torch.Tensor:
    """Elements ``[start, start + count)`` of a flat draw of 32-bit words
    (int64 in ``[0, 2^32)``)."""
    flat = torch.arange(count, dtype=torch.int64, device=device) + start
    x0, x1 = threefry2x32(key, flat >> 32, flat & MASK32)
    return x0 ^ x1


def uniform_of_bits(words: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    mantissa = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo32 = torch.tensor(lo, dtype=torch.float32, device=words.device)
    span = torch.tensor(hi, dtype=torch.float32, device=words.device) - lo32
    return torch.maximum(lo32, (mantissa - 1.0) * span + lo32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision inverse error function (XLA's ErfInv32)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(i: int) -> torch.Tensor:
        below, above = (
            torch.tensor(c[i], dtype=torch.float32, device=x.device)
            for c in (ERFINV_W_LT_5, ERFINV_W_GE_5)
        )
        return torch.where(lt, below, above)

    p = coefficient(0)
    for i in range(1, len(ERFINV_W_LT_5)):
        p = coefficient(i) + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normals(key, start: int, count: int, device) -> torch.Tensor:
    """Elements ``[start, start + count)`` of ``jax.random.normal(key,
    ...)``'s flat float32 draw."""
    u = uniform_of_bits(bits(key, start, count, device), NORMAL_LO, NORMAL_HI)
    return torch.tensor(SQRT2, dtype=torch.float32, device=device) * erf_inv(u)
