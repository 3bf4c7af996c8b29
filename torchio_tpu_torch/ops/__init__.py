"""Device ops: the resamples, the Gaussian blur and the CUDA kernels.

Exports the dense-coordinate entry of ``torchio_tpu.ops``
(:func:`build_coords`, :func:`resample`, :func:`upsample_field`) and its
separable Gaussian blur (:func:`gaussian_blur`,
:func:`gaussian_blur_per_element`).
"""

from .gaussian import gaussian_blur, gaussian_blur_per_element
from .resample import build_coords, resample, upsample_field

__all__ = [
    "build_coords",
    "gaussian_blur",
    "gaussian_blur_per_element",
    "resample",
    "upsample_field",
]
