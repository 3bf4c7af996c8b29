"""Motion: k-space segment corruption (Shaw et al. 2019).

Counterpart of ``torchio_tpu/transforms/intensity/motion.py``: the
k-space of each image is split along the first spatial axis into
``num_transforms + 1`` segments; every segment but the first takes the
spectrum of a rigidly moved copy of the image; the result is the real
part of the inverse FFT, in the input dtype.

The rigid moves are the JAX package's output-voxel -> input-voxel maps,
float64 host math with the reference's ``affine_grid`` normalisation
quirks (:func:`_rigid_voxel_matrix`). Each move is resampled at a dense
coordinate grid (:func:`torchio_tpu_torch.ops.resample.build_coords`)
through the dense branch of the spatial dispatch, which runs the
dense-coordinate CUDA kernel on a CUDA batch. The FFTs are ``torch.fft``,
where the JAX package uses XLA's. A sharded batch stays on each rank's
region: each rank takes its rows whole along J (gathered over ``space``
only, :func:`..parallel.mesh.map_rows`), with their own moves, and keeps
its columns of the result.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.dtypes import cast_like_jax
from ...data.batch import SubjectsBatch
from ...ops.resample import build_coords
from ...parallel.mesh import map_rows, region_of
from .._utils import restore_gated
from ..parameter_range import to_range
from ..transform import IntensityTransform

_SPATIAL = (-3, -2, -1)


def _axis_rotation(angle: float, axis: int) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(3)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    m[a, a] = m[b, b] = c
    m[a, b] = -s if axis != 1 else s
    m[b, a] = s if axis != 1 else -s
    return m


def _rigid_voxel_matrix(degrees, translation, shape) -> np.ndarray:
    """Output-voxel -> input-voxel 4x4 map of the reference's rigid move.

    The reference builds ``theta = [Rz@Ry@Rx | t]`` for
    ``affine_grid(align_corners=True)``: the rotation acts in normalized
    grid coordinates with axis order (x, y, z) = (K, J, I), so anisotropic
    volumes shear rather than rotate rigidly, and the translation is
    normalized by ``(I, J, K) / 2`` but applied to rows (x, y, z). Both
    quirks are kept, composed into one voxel-space map.
    """
    rx, ry, rz = np.deg2rad(np.asarray(degrees, np.float64))
    r = _axis_rotation(rz, 2) @ _axis_rotation(ry, 1) @ _axis_rotation(rx, 0)
    si, sj, sk = (float(s) for s in shape)
    sizes_xyz = np.array([sk, sj, si])  # affine_grid x, y, z extents
    t_norm = np.asarray(translation, np.float64) / (np.array([si, sj, sk]) / 2)
    # voxel -> normalized per xyz axis: n = a*v - 1 (align_corners=True)
    a = 2.0 / np.maximum(sizes_xyz - 1.0, 1.0)
    half = np.maximum(sizes_xyz - 1.0, 1.0) / 2.0
    ones = np.ones(3)
    a_xyz = half[:, None] * r * a[None, :]
    c_xyz = half * (r @ (-ones) + t_norm + ones)
    perm = np.zeros((3, 3))  # (i, j, k) voxel order -> (k, j, i) xyz order
    perm[0, 2] = perm[1, 1] = perm[2, 0] = 1.0
    m = np.eye(4)
    m[:3, :3] = perm.T @ a_xyz @ perm
    m[:3, 3] = perm.T @ c_xyz
    return m


def _move_batch(data: torch.Tensor, degrees_list, translation_list) -> torch.Tensor:
    """Per-element rigid moves: one dense (B, I, J, K, 3) coordinate grid
    on the batch's device, resampled linearly with no fill."""
    from ..spatial.spatial import _dispatch_resample

    shape = tuple(int(s) for s in data.shape[2:])
    coords = torch.stack(
        [
            build_coords(shape, _rigid_voxel_matrix(d, t, shape), device=data.device)
            for d, t in zip(degrees_list, translation_list)
        ]
    )
    return _dispatch_resample(data, coords, mode="linear", fill=0.0)


_IDENTITY = {"degrees": (0.0, 0.0, 0.0), "translation": (0.0, 0.0, 0.0)}


class Motion(IntensityTransform):
    r"""Simulate MRI motion artifacts via k-space segment substitution.

    Args:
        degrees: rotation range (degrees) of each simulated move.
        translation: translation range (voxels) of each simulated move.
        num_transforms: number of moves, i.e. k-space segments after the
            first.
    """

    takes_sharded = True

    def __init__(
        self,
        *,
        degrees: Any = 10.0,
        translation: Any = 10.0,
        num_transforms: int = 2,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.degrees = to_range(degrees)
        self.translation = to_range(translation)
        if not isinstance(num_transforms, int) or num_transforms < 1:
            raise ValueError(
                f"num_transforms must be a positive int, got {num_transforms}"
            )
        self.num_transforms = num_transforms

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def _sample_transforms(self) -> list[dict]:
        return [
            {
                "degrees": list(self.degrees.sample()),
                "translation": list(self.translation.sample()),
            }
            for _ in range(self.num_transforms)
        ]

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        n = self._resolve_n(batch)
        if n is None:
            return {"transforms": self._sample_transforms()}
        keep = self._keep_mask(batch, n)
        transforms = [
            [] if (keep is not None and not keep[i]) else self._sample_transforms()
            for i in range(n)
        ]
        params = {"transforms": transforms}
        self._tag_batched(params, batch, n, keep, ["transforms"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        transforms = params["transforms"]
        per_instance = self._is_per_instance_params(params)
        for img_batch in self._get_images(batch).values():
            data = img_batch.data
            if per_instance:
                num_transforms = max((len(t) for t in transforms), default=0)
                if num_transforms == 0:
                    continue
                per_element = transforms
                keep = [bool(t) for t in transforms]
            else:
                num_transforms = len(transforms)
                per_element = [transforms] * data.shape[0]
                keep = None
            mine = region_of(data).take(per_element)
            out = map_rows(lambda rows: _apply_motion(rows, mine, num_transforms), data)
            img_batch.data = restore_gated(out, data, keep)
        return batch


def _apply_motion(data: torch.Tensor, per_element_transforms, num_transforms: int):
    """Splice the spectra of the moved copies into the image's spectrum
    along the first spatial axis; returns the real part in ``data``'s
    dtype. Elements without transforms move by the identity."""
    if data.shape[0] == 0:  # a rank that holds no rows of a sharded batch
        return data
    result = data.to(torch.float32)
    num_segments = num_transforms + 1
    first_size = result.shape[2]
    segment_size = first_size // num_segments
    if segment_size == 0:
        raise ValueError(
            f"Cannot split {first_size} k-space slices into {num_segments}"
            " motion segments; reduce num_transforms or use a larger image"
            " along the first spatial axis."
        )
    spectrum = torch.fft.fftn(result, dim=_SPATIAL)
    for segment_index in range(1, num_segments):
        degrees_list, translation_list = [], []
        for transforms in per_element_transforms:
            t = transforms[segment_index - 1] if transforms else _IDENTITY
            degrees_list.append(t["degrees"])
            translation_list.append(t["translation"])
        moved = _move_batch(result, degrees_list, translation_list)
        moved_spectrum = torch.fft.fftn(moved, dim=_SPATIAL)
        del moved
        start = segment_index * segment_size
        end = first_size if segment_index == num_segments - 1 else start + segment_size
        # in place: the spectrum is this function's own buffer
        spectrum[:, :, start:end] = moved_spectrum[:, :, start:end]
        del moved_spectrum
    return cast_like_jax(torch.fft.ifftn(spectrum, dim=_SPATIAL).real.contiguous(), data.dtype)
