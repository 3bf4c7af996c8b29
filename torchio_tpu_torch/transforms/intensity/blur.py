"""Blur: random separable Gaussian smoothing (sigmas in mm).

Counterpart of ``torchio_tpu/transforms/intensity/blur.py``: sigma in mm
converted to voxels with each element's spacing, a random sigma per
axis, per-element kernels truncated at each element's own radius, and
elements drawn with no blur left bit-exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ...data.batch import ImagesBatch, SubjectsBatch
from ...ops.gaussian import gaussian_blur, gaussian_blur_per_element, per_element_radii
from .._utils import restore_gated
from ..parameter_range import to_nonneg_range
from ..transform import IntensityTransform


class Blur(IntensityTransform):
    r"""Gaussian blur with per-axis standard deviations sampled in mm.

    On a sharded batch an axis the mesh splits takes halo taps (see
    :mod:`...ops.gaussian`), fused or not."""

    takes_sharded = True

    def __init__(self, *, std: Any = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.std = to_nonneg_range(std)
        self.warn_if_noop(is_noop=self.std.is_constant(0.0), hint="std=(0, 2)")

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        n = self._resolve_n(batch)
        if n is None:
            return {"std": list(self.std.sample())}
        keep = self._keep_mask(batch, n)
        std = self.std.sample(n)
        if keep is not None:
            std[~keep] = 0.0
        params = {"std": self._serialize_param(std)}
        self._tag_batched(params, batch, n, keep, ["std"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        per_instance = self._is_per_instance_params(params)
        for img_batch in self._get_images(batch).values():
            radii = self._radius_bound(img_batch)
            if per_instance:
                img_batch.data = _blur_per_element(img_batch, params["std"], radii=radii)
            else:
                spacing = np.asarray(img_batch.affines[0].spacing, np.float64)
                sigmas_vox = _mm_to_voxels(np.asarray(params["std"]), spacing)
                if np.all(sigmas_vox <= 0):
                    continue
                img_batch.data = gaussian_blur(img_batch.data, sigmas_vox, radii=radii)
        return batch

    def fusable(self, batch: SubjectsBatch) -> bool:
        # only the per-instance path fuses, as in the JAX package
        return bool(self._get_images(batch)) and self._per_instance_active(batch)

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, blur_apply

        images = self._get_images(batch)
        if not images:
            return None
        params = self.make_params(batch)
        sig_mm = np.asarray(params["std"], np.float64)
        args = {}
        for name, img_batch in images.items():
            sig_vox = _element_sigmas(img_batch, sig_mm)
            row_keep = ~np.all(sig_vox <= 0, axis=1)
            args[name] = (
                sig_vox,
                per_element_radii(sig_vox, radii=self._radius_bound(img_batch)),
                row_keep,
            )
        names = tuple(images)
        return FusedStage(
            names=names,
            apply=blur_apply(names, 3.0),
            args=args,
            params=params,
            takes_sharded=True,
        )

    def _radius_bound(self, img_batch: ImagesBatch) -> tuple[int, int, int]:
        """Per-axis kernel support from the std range's UPPER bound, so
        every draw of one transform uses one support (the JAX package
        keeps one compiled program; here it keeps the band shapes)."""
        spacings = np.asarray([a.spacing for a in img_batch.affines], np.float64)
        min_spacing = np.maximum(spacings.min(axis=0), 1e-9)
        highs = np.asarray([hi for _lo, hi in self.std._ranges], np.float64)
        sig_vox = highs / min_spacing
        return tuple(0 if s <= 0 else max(int(np.ceil(3.0 * s)), 1) for s in sig_vox)


def _mm_to_voxels(sigmas_mm: np.ndarray, spacing: np.ndarray) -> np.ndarray:
    return np.divide(
        sigmas_mm, spacing, out=np.zeros_like(sigmas_mm, np.float64), where=spacing > 0
    )


def _element_sigmas(img_batch: ImagesBatch, sigmas_mm: np.ndarray) -> np.ndarray:
    """(B, 3) voxel sigmas from (B, 3) mm sigmas and each element's
    spacing."""
    spacings = np.asarray([a.spacing for a in img_batch.affines], np.float64)
    return np.divide(sigmas_mm, spacings, out=np.zeros_like(sigmas_mm), where=spacings > 0)


def _blur_per_element(img_batch: ImagesBatch, sigmas_mm_per_element, radii=None):
    data = img_batch.data
    sigmas_vox = _element_sigmas(img_batch, np.asarray(sigmas_mm_per_element, np.float64))
    if np.all(sigmas_vox <= 0):
        return data
    out = gaussian_blur_per_element(data, sigmas_vox, radii=radii)
    # rows with all-zero sigma must be bit-exact no-ops
    keep = ~np.all(sigmas_vox <= 0, axis=1)
    return restore_gated(out, data, keep)
