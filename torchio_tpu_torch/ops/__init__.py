"""Device ops: the resamples and their CUDA kernels.

Exports the dense-coordinate entry of ``torchio_tpu.ops``:
:func:`build_coords`, :func:`resample` and :func:`upsample_field`. The
JAX package's ``gaussian_blur`` and ``gaussian_blur_per_element`` are not
ported yet: they come with Blur, in the slice of the other BASELINE.json
configurations (config 2).
"""

from .resample import build_coords, resample, upsample_field

__all__ = ["build_coords", "resample", "upsample_field"]
