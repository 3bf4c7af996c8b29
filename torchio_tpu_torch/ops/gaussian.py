"""Separable 3D Gaussian smoothing as band-matrix products.

Counterpart of ``torchio_tpu/ops/gaussian.py``. Each 1D pass is the
product of the volume with a banded ``(n, n)`` matrix along its axis,
the edge-replicated boundary folded into the matrix rows:
``out[i] = sum_t kernel[t] * in[clip(i + t - r, 0, n - 1)]``. The JAX
package computes these products with XLA (no Pallas kernel); here they
are ``torch.einsum`` on the batch's device, float32 throughout.

- :func:`gaussian_blur`: one sigma triplet for the whole batch (band
  matrices built on the host);
- :func:`gaussian_blur_per_element`: a sigma triplet per element; each
  element's band matrices are built on the device from a shift-matrix
  basis.

Both zero the taps beyond each sigma's own radius ``ceil(truncate *
sigma)`` and renormalize, so a wider ``radii`` (from a parameter range's
upper bound) gives the same numbers. Axes with sigma <= 0 are skipped
(an element's all-zero sigma row is the identity).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.dtypes import cast_like_jax


def gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(2 * radius + 1, dtype=np.float32) - radius
    k = np.exp(-0.5 * (x / max(sigma, 1e-9)) ** 2)
    return k / k.sum()


def radius_for_sigma(sigma: float, truncate: float = 3.0) -> int:
    return max(int(np.ceil(truncate * sigma)), 1)


def _band_matrix(kernel: np.ndarray, n: int) -> np.ndarray:
    """(n, n) convolution matrix with edge replication folded in."""
    radius = (len(kernel) - 1) // 2
    rows = np.arange(n)
    W = np.zeros((n, n), np.float32)
    for t, w in enumerate(kernel):
        np.add.at(W, (rows, np.clip(rows + t - radius, 0, n - 1)), float(w))
    return W


@lru_cache(maxsize=32)
def _shift_basis(radius: int, n: int) -> np.ndarray:
    """(2r+1, n, n) basis of edge-replicated shift matrices, so a
    per-element band matrix is ``einsum('t,tij->ij', taps, basis)``."""
    rows = np.arange(n)
    basis = np.zeros((2 * radius + 1, n, n), np.float32)
    for t in range(2 * radius + 1):
        np.add.at(basis[t], (rows, np.clip(rows + t - radius, 0, n - 1)), 1.0)
    return basis


@lru_cache(maxsize=32)
def _device_basis(radius: int, n: int, device: torch.device) -> torch.Tensor:
    """:func:`_shift_basis` on ``device``, copied there once (the JAX
    package embeds it in its compiled program as a constant)."""
    return torch.as_tensor(_shift_basis(radius, n), device=device)


_AXIS_EINSUM = (
    "bcijk,xi->bcxjk",
    "bcijk,xj->bcixk",
    "bcijk,xk->bcijx",
)
_AXIS_EINSUM_BATCHED = (
    "bcijk,bxi->bcxjk",
    "bcijk,bxj->bcixk",
    "bcijk,bxk->bcijx",
)


def gaussian_blur(data, sigmas, truncate: float = 3.0, radii=None) -> torch.Tensor:
    """Blur (B, C, I, J, K) or (C, I, J, K) with per-axis voxel sigmas.

    ``sigmas`` is a length-3 host array; axes with sigma <= 0 are skipped.
    ``radii`` optionally widens the per-axis kernel support; taps beyond
    each sigma's own ``ceil(truncate * sigma)`` stay zero, so the result
    is the same either way.
    """
    unbatched = data.ndim == 4
    if unbatched:
        data = data[None]
    sig = np.asarray(sigmas, np.float64).reshape(3)
    out = data.to(torch.float32)
    for axis in range(3):
        s = float(sig[axis])
        if s <= 0:
            continue
        own = radius_for_sigma(s, truncate)
        radius = own if radii is None else max(int(radii[axis]), own)
        kernel = gaussian_kernel_1d(s, radius)
        if radius > own:  # zero padded taps; renormalize
            x = np.abs(np.arange(2 * radius + 1) - radius)
            kernel = np.where(x <= own, kernel, 0.0)
            kernel = kernel / kernel.sum()
        band = torch.as_tensor(_band_matrix(kernel, data.shape[2 + axis]), device=data.device)
        out = torch.einsum(_AXIS_EINSUM[axis], out, band)
    out = cast_like_jax(out, data.dtype)
    return out[0] if unbatched else out


def blur_per_element(data: torch.Tensor, sigmas: torch.Tensor, radii, truncate: float = 3.0):
    """data (B, C, I, J, K); sigmas (B, 3) float32 on data's device; radii
    the static per-axis support. Returns float32."""
    out = data.to(torch.float32)
    for axis in range(3):
        radius = radii[axis]
        if radius == 0:
            continue
        n = data.shape[2 + axis]
        ksize = 2 * radius + 1
        x = torch.arange(ksize, dtype=torch.float32, device=data.device) - radius
        sig_col = sigmas[:, axis][:, None]  # (B, 1)
        s = torch.clamp(sig_col, min=1e-9)
        k = torch.exp(-0.5 * (x[None, :] / s) ** 2)  # (B, ksize)
        # zero the taps beyond each element's own radius, so the batched
        # kernel equals the one a single-element call builds
        own_radius = torch.clamp(torch.ceil(truncate * sig_col), min=1.0)
        k = torch.where(torch.abs(x)[None, :] <= own_radius, k, 0.0)
        # sigma == 0 -> identity kernel
        ident = torch.zeros(ksize, dtype=torch.float32, device=data.device)
        ident[radius] = 1.0
        k = torch.where(sig_col > 0, k, ident[None, :])
        k = k / torch.sum(k, dim=1, keepdim=True)
        w = torch.einsum("bt,tij->bij", k, _device_basis(radius, n, data.device))
        out = torch.einsum(_AXIS_EINSUM_BATCHED[axis], out, w)
    return out


def per_element_radii(sigmas: np.ndarray, truncate: float = 3.0, radii=None) -> tuple:
    """The static per-axis support of a (B, 3) host sigma array: the
    largest drawn sigma's radius, widened to ``radii``."""
    drawn = tuple(
        0 if sigmas[:, a].max() <= 0 else radius_for_sigma(float(sigmas[:, a].max()), truncate)
        for a in range(3)
    )
    if radii is not None:
        drawn = tuple(max(int(radii[a]), drawn[a]) for a in range(3))
    return drawn


def gaussian_blur_per_element(data, sigmas, truncate: float = 3.0, radii=None):
    """Blur each batch element with its own per-axis sigmas.

    ``sigmas`` is a host (B, 3) array. The support per axis derives from
    the largest sigma drawn, widened to ``radii`` if given; taps beyond
    each element's own ``ceil(truncate * sigma)`` are zero either way.
    """
    sig = np.asarray(sigmas, np.float64).reshape(data.shape[0], 3)
    out = blur_per_element(
        data,
        torch.as_tensor(sig.astype(np.float32), device=data.device),
        per_element_radii(sig, truncate, radii),
        float(truncate),
    )
    return cast_like_jax(out, data.dtype)
