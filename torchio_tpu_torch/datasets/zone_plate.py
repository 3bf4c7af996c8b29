"""Synthetic zone-plate volume (offline; useful for interpolation tests).

The port's copy of ``torchio_tpu/datasets/zone_plate.py`` (Jähne,
Practical Handbook on Image Processing, eq. 10.63).
"""

from __future__ import annotations

import numpy as np

from ..data.image import ScalarImage
from ..data.subject import Subject


class ZonePlate(Subject):
    """Concentric diffraction-ring phantom of the given cubic size."""

    def __init__(self, size: int = 501) -> None:
        if size < 3:
            raise ValueError("Size must be at least 3.")
        self.size = size
        super().__init__(image=self._generate_image(size))

    @staticmethod
    def _generate_image(size: int) -> ScalarImage:
        # centered integer lattice: odd sizes are symmetric about 0,
        # even sizes start one step later so the extent stays `size`
        origin = -(size - 1) // 2 if size % 2 else -(size // 2) + 1
        axis = np.arange(origin, origin + size, dtype=np.float64)
        grids = np.meshgrid(axis, axis, axis)
        radius = np.sqrt(sum(g * g for g in grids))
        # eq. 10.63: chirp sin(km r^2 / 2 rm) faded by a tanh envelope
        km, rm = 0.8 * np.pi, float(origin)
        envelope = 0.5 * (np.tanh((rm - radius) / (rm / 10)) + 1.0)
        plate = np.sin(km * radius * radius / (2.0 * rm)) * envelope
        affine = np.eye(4)
        affine[:3, 3] = origin
        return ScalarImage(plate[None].astype(np.float32), affine=affine)
