"""Unified spatial transform: affine + elastic in ONE grid pass.

Counterpart of ``torchio_tpu/transforms/spatial/spatial.py``:

- One sampling grid per call composes a world affine (scales, degrees,
  translation about ``center``) and a dense elastic field upsampled from
  coarse control points (mm), with the ``affine_first`` ordering flag.
- The output voxel -> input voxel map ``A_in^-1 @ T^-1 @ A_out`` is
  float64 host math; only the float32 map reaches the device.
- Interpolation orders 0-7 by name or number (``"bspline"`` is cubic),
  and ``label_interpolation="label"``: partial-volume label resampling
  (one-hot -> interpolate -> argmax, with the > 50 % in-bounds rule).
- Out-of-bounds fill: a number, or ``"minimum"`` computed per element
  and channel on the device; ``default_pad_label`` for label maps.
- Per-instance geometry with bit-exact passthrough of gated-out
  elements; the input dtype is restored after sampling.

The parameters are drawn by the same host numpy code as the JAX package,
so the same seed records the same params. Each image is resampled by one
call on the batch's device, each with a hand-written CUDA kernel behind
it: orders 0-1 by :func:`torchio_tpu_torch.ops.resample.resample_fused`,
orders 2-7 by :func:`torchio_tpu_torch.ops.bspline.bspline_resample_fused`
(prefilter, then taps), and a one-channel label map in "label" mode with
linear one-hot interpolation by
:func:`torchio_tpu_torch.ops.resample.resample_label_fused` (the corner
vote, which gives the one-hot result without the label set).
:func:`_dispatch_resample` also takes a dense coordinate tensor, as the
JAX package's does for every non-lazy grid (Motion's rigid moves):
orders 0-1 go to :func:`torchio_tpu_torch.ops.resample.resample`,
orders 2-7 to :func:`torchio_tpu_torch.ops.bspline.bspline_resample`,
each on a dense-coordinate CUDA kernel. The JAX package's ``plans`` and
its opt-in Pallas tiled kernel (``TORCHIO_TPU_PALLAS``) have no
counterpart: the port has one dense kernel.

Target spaces (``target=``, and :class:`Resample`): an Image, the name
of an image in the batch, a ``(shape, affine)`` pair, or a spacing spec
(a number, an array, a 3-tuple, a range, a ``Choice`` or a
distribution), resolved on the host as the JAX package resolves them; the
output takes the target's shape and affine and goes through the same
resample kernels (a diagonal map, which the JAX package computes with
separable matmuls, is one more gather map here). Antialiasing blurs
images with :func:`torchio_tpu_torch.ops.gaussian.gaussian_blur` before
the resample, and label maps in "label" mode take the one-hot path. The
"mean" and "otsu" fills are float64 border statistics of the six faces,
computed on the host per element and channel as the JAX package computes
them. The inverse (:class:`_SpatialInverse`) inverts the matrices in
float64, negates the control points, flips ``affine_first`` and resamples
to the recorded original space. A target given as a file path needs
file I/O, which is not ported.
"""

from __future__ import annotations

import warnings
from numbers import Number
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...core.affine import AffineMatrix
from ...data.batch import ImagesBatch, SubjectsBatch
from ...data.image import Image, LabelMap
from ...ops.bspline import bspline_resample, bspline_resample_fused
from ...ops.gaussian import gaussian_blur
from ...ops.resample import resample, resample_fused, resample_label_fused
from .._utils import unique_labels
from ..parameter_range import Choice, _is_distribution, _ParameterRange
from ..transform import SpatialTransform

_INTERPOLATION_TO_ORDER = {
    "nearest": 0,
    "linear": 1,
    "quadratic": 2,
    "cubic": 3,
    "fourth": 4,
    "fifth": 5,
    "sixth": 6,
    "seventh": 7,
}
_ORDER_TO_INTERPOLATION = {v: k for k, v in _INTERPOLATION_TO_ORDER.items()}
LABEL_INTERPOLATION = "label"
_SPLINE_ORDER = 3  # coarse-grid folding heuristic, matches the JAX package


def _parse_interpolation(value) -> str:
    if isinstance(value, (int, np.integer)):
        if int(value) not in _ORDER_TO_INTERPOLATION:
            raise ValueError(f"Interpolation order must be 0-7, got {value}")
        return _ORDER_TO_INTERPOLATION[int(value)]
    name = str(value).lower()
    if name == LABEL_INTERPOLATION:
        return LABEL_INTERPOLATION
    if name == "bspline":
        return "cubic"
    if name == "trilinear":
        return "linear"
    if name not in _INTERPOLATION_TO_ORDER:
        raise ValueError(
            f"Unknown interpolation {value!r}; use one of"
            f" {list(_INTERPOLATION_TO_ORDER)} or 'label'"
        )
    return name


# --------------------------------------------------------------------------
# Host geometry helpers (float64 numpy)
# --------------------------------------------------------------------------


def _euler_rotation(degrees: np.ndarray) -> np.ndarray:
    """XYZ-intrinsic (ZYX-extrinsic) Euler angles (deg) -> 3x3 rotation."""
    rx, ry, rz = np.radians(np.asarray(degrees, np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    r_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return r_z @ r_y @ r_x


def _image_center_world(shape, affine: AffineMatrix) -> np.ndarray:
    center_index = (np.asarray(shape, np.float64) - 1) / 2
    m = affine.data
    return m[:3, 3] + m[:3, :3] @ center_index


def _forward_affine(
    *, scales, degrees, translation, center: str, shape, affine: AffineMatrix
) -> np.ndarray:
    """4x4 world-space affine: T = R @ S pivoting about the image center."""
    scaling = np.asarray(scales, np.float64).copy()
    rotation = np.asarray(degrees, np.float64).copy()
    shift = np.asarray(translation, np.float64).copy()
    if shape[-1] == 1:  # 2D slice: suppress out-of-plane components
        scaling[2] = 1.0
        rotation[0] = rotation[1] = 0.0
        shift[2] = 0.0
    rs = _euler_rotation(rotation) @ np.diag(scaling)
    t = np.eye(4, dtype=np.float64)
    t[:3, :3] = rs
    if center == "image":
        c = _image_center_world(shape, affine)
        t[:3, 3] = c - rs @ c
    t[:3, 3] += shift
    return t


def _compute_new_shape_affine(shape, affine: AffineMatrix, spacing):
    """Output (shape, affine) for a target spacing, physical center fixed."""
    old_spacing = np.asarray(affine.spacing, np.float64)
    new_spacing = np.asarray(spacing, np.float64)
    old_shape = np.asarray(shape, np.float64)
    new_shape = np.floor(old_shape * old_spacing / new_spacing)
    new_shape[old_shape == 1] = 1
    rotation = affine.direction
    old_origin = np.asarray(affine.origin, np.float64)
    old_center = old_origin + rotation @ (((old_shape - 1) / 2) * old_spacing)
    new_origin = old_center - rotation @ (((new_shape - 1) / 2) * new_spacing)
    new_affine = np.eye(4, dtype=np.float64)
    new_affine[:3, :3] = rotation * new_spacing
    new_affine[:3, 3] = new_origin
    return (
        (int(new_shape[0]), int(new_shape[1]), int(new_shape[2])),
        AffineMatrix(new_affine),
    )


def _parse_spacing(value) -> tuple[float, float, float]:
    if isinstance(value, (int, float)):
        out = (float(value),) * 3
    else:
        vals = tuple(float(v) for v in value)
        if len(vals) == 1:
            out = vals * 3
        elif len(vals) == 3:
            out = vals
        else:
            raise ValueError(f"Spacing must have 1 or 3 values, got {len(vals)}")
    if any(s <= 0 for s in out):
        raise ValueError(f"Spacing must be positive, got {out}")
    return out  # type: ignore[return-value]


def _is_target_space_tuple(target) -> bool:
    if not isinstance(target, (tuple, list)) or len(target) != 2:
        return False
    shape, affine = target
    return isinstance(shape, (tuple, list, np.ndarray)) and (
        isinstance(affine, AffineMatrix)
        or (isinstance(affine, (np.ndarray, list)) and np.asarray(affine).shape == (4, 4))
    )


def _resolve_target_space(target, batch, first_shape, first_affine):
    """User-facing target spec -> (shape, AffineMatrix) or None."""
    if target is None:
        return None
    if isinstance(target, Image):
        return target.spatial_shape, target.affine.clone()
    if isinstance(target, (str, Path)):
        if Path(target).is_file():
            raise NotImplementedError(
                f'Target "{target}" is a file: reading images from files is not'
                " ported yet (ROADMAP.md, Queue 1, item 10); pass an Image, an"
                " image name, a (shape, affine) pair or a spacing"
            )
        if isinstance(target, str) and batch is not None and target in batch.images:
            ref = batch.images[target]
            return tuple(ref.data.shape[-3:]), ref.affines[0].clone()
        raise ValueError(
            f'Unknown target "{target}": pass a file path, an image name'
            " in the subject, an Image, or a spacing spec"
        )
    if _is_target_space_tuple(target):
        shape, affine = target
        shape = tuple(int(s) for s in shape)
        return shape, AffineMatrix(affine)
    if isinstance(target, np.ndarray):
        return _compute_new_shape_affine(
            first_shape, first_affine, _parse_spacing(tuple(target.flat))
        )
    if isinstance(target, (int, float)):
        return _compute_new_shape_affine(first_shape, first_affine, float(target))
    if isinstance(target, (tuple, list, Choice)) or _is_distribution(target):
        spec = tuple(target) if isinstance(target, list) else target
        if isinstance(spec, tuple) and len(spec) == 3 and all(
            isinstance(v, (int, float)) for v in spec
        ):
            spacing = _parse_spacing(spec)
        else:
            spacing = _parse_spacing(_ParameterRange(spec).sample())
        return _compute_new_shape_affine(first_shape, first_affine, spacing)
    raise ValueError(f'Target not understood: "{target}"')


def _sample_control_points(grid_shape, max_displacement, locked_borders: int):
    """Random uniform [-max, max] field (n_i, n_j, n_k, 3) with zeroed borders."""
    rng = tio_random.get_rng()
    field = rng.uniform(-1.0, 1.0, size=tuple(grid_shape) + (3,)).astype(np.float32)
    for axis in range(3):
        field[..., axis] *= max_displacement[axis]
    for border in range(locked_borders):
        field[border, :] = 0
        field[-1 - border, :] = 0
        field[:, border] = 0
        field[:, -1 - border] = 0
        field[:, :, border] = 0
        field[:, :, -1 - border] = 0
    return field


def _check_folding(control_points, max_displacement, shape, spacing) -> None:
    num_cp = np.array(control_points.shape[:-1], np.float64)
    bounds = np.array(shape, np.float64) * np.asarray(spacing, np.float64)
    grid_spacing = bounds / (num_cp - _SPLINE_ORDER)
    conflicts = np.asarray(max_displacement, np.float64) > grid_spacing / 2
    if conflicts.any():
        (where,) = np.where(conflicts)
        warnings.warn(
            "The maximum displacement is larger than half the coarse-grid"
            f" spacing for dimensions {where.tolist()}, so folding may occur",
            RuntimeWarning,
            stacklevel=3,
        )


def _field_displacement_extent(control_points) -> tuple[float, float, float]:
    m = np.abs(np.asarray(control_points)).reshape(-1, 3).max(axis=0)
    return (float(m[0]), float(m[1]), float(m[2]))


def _antialias_sigmas(factors, spacing) -> np.ndarray:
    """Per-axis voxel sigmas (Cardoso et al. MICCAI 2015)."""
    sigmas = np.zeros(3, np.float64)
    for axis in range(3):
        k = factors[axis]
        if k <= 1.0:
            continue
        variance = (k**2 - 1) * (2 * np.sqrt(2 * np.log(2))) ** (-2)
        sigmas[axis] = np.sqrt(variance)  # sigma_mm / spacing == sqrt(var)
    return sigmas


def _otsu_threshold(values: np.ndarray) -> float:
    """Between-class-variance-maximizing threshold over sorted values."""
    v = np.sort(values.astype(np.float64))
    n = v.size
    if n < 2:
        return float(v[0]) if n else 0.0
    csum = np.cumsum(v)
    total = csum[-1]
    counts = np.arange(1, n)
    mean_low = csum[:-1] / counts
    mean_high = (total - csum[:-1]) / (n - counts)
    weight_low = counts / n
    between = weight_low * (1 - weight_low) * (mean_low - mean_high) ** 2
    best = int(np.argmax(between))
    return float((v[best] + v[best + 1]) / 2)


def _border_values(data: torch.Tensor) -> np.ndarray:
    """(B, C, n) host copy of the six faces of a (B, C, I, J, K) tensor,
    in the JAX package's order: i = 0, i = -1, j = 0, j = -1, k = 0,
    k = -1. The faces overlap at edges and corners, and those voxels
    count once per face. One transfer of a few MB."""
    faces = [
        data[:, :, 0], data[:, :, -1],
        data[:, :, :, 0], data[:, :, :, -1],
        data[:, :, :, :, 0], data[:, :, :, :, -1],
    ]
    b, c = data.shape[:2]
    flat = torch.cat([f.reshape(b, c, -1) for f in faces], dim=2)
    return flat.detach().cpu().numpy()


def _batch_fill_value(img_batch: ImagesBatch, *, default_pad_value, default_pad_label):
    """Out-of-bounds fill: a number; a (B, C) tensor of per-element,
    per-channel minima computed on the batch's device ("minimum"); or a
    (B, C) float32 host array of per-element, per-channel float64 border
    statistics ("mean", and "otsu": the mean of the border voxels below
    their Otsu threshold)."""
    if issubclass(img_batch.image_class, LabelMap):
        return float(default_pad_label)
    if isinstance(default_pad_value, Number):
        return float(default_pad_value)
    if not isinstance(default_pad_value, str):
        raise TypeError(
            f"default_pad_value must be a string or number, got {type(default_pad_value)}"
        )
    if default_pad_value == "minimum":
        return torch.amin(img_batch.data, dim=(-3, -2, -1))
    if default_pad_value not in ("mean", "otsu"):
        raise ValueError(f'Unknown default_pad_value "{default_pad_value}"')
    borders = _border_values(img_batch.data)
    values = np.zeros(borders.shape[:2], np.float32)
    for b in range(borders.shape[0]):
        for c in range(borders.shape[1]):
            flat = borders[b, c].astype(np.float64)
            if default_pad_value == "mean":
                values[b, c] = flat.mean()
            else:
                threshold = _otsu_threshold(flat)
                vals = flat[flat < threshold]
                values[b, c] = vals.mean() if vals.size else flat.mean()
    return values


# --------------------------------------------------------------------------
# Grid construction (host matrix math)
# --------------------------------------------------------------------------


def _mapping_matrix(input_affine, output_affine, affine_matrix) -> np.ndarray:
    """Output voxel -> input voxel 4x4 (``A_in^-1 @ T^-1 @ A_out``, f64)."""
    t_inv = (
        np.eye(4)
        if affine_matrix is None
        else np.linalg.inv(np.asarray(affine_matrix, np.float64))
    )
    return np.linalg.inv(input_affine.data) @ t_inv @ output_affine.data


def _build_grid(
    *,
    input_affine: AffineMatrix,
    output_shape,
    output_affine: AffineMatrix,
    affine_matrix,
    control_points,
    max_displacement,
    affine_first: bool,
):
    """(4x4 output->input map, pre-folded control points or None).

    The trilinear upsample is linear in the control points, so spacing
    and, for affine-last ordering, the rotation fold into the coarse
    field on the host (float64) and the resample upsamples it directly.
    """
    mapping = _mapping_matrix(input_affine, output_affine, affine_matrix)
    if control_points is None:
        return mapping, None
    if max_displacement is None:
        max_displacement = _field_displacement_extent(control_points)
    _check_folding(
        np.asarray(control_points),
        max_displacement,
        output_shape,
        np.asarray(output_affine.spacing),
    )
    cp = np.asarray(control_points, np.float64)
    if affine_first:
        return mapping, cp / np.asarray(input_affine.spacing, np.float64)
    folded = (cp / np.asarray(output_affine.spacing, np.float64)) @ mapping[:3, :3].T
    return mapping, folded


# --------------------------------------------------------------------------
# Parameter (de)serialization
# --------------------------------------------------------------------------


def _serialize_space(space):
    if space is None:
        return None
    shape, affine = space
    return {"shape": [int(s) for s in shape], "affine": AffineMatrix(affine).tolist()}


def _deserialize_space(data):
    if data is None:
        return None
    return tuple(data["shape"]), AffineMatrix(data["affine"])


def _serialize_matrix(matrix):
    return None if matrix is None else np.asarray(matrix, np.float64).tolist()


def _deserialize_matrix(data):
    return None if data is None else np.asarray(data, np.float64)


def _serialize_control_points(cp):
    return None if cp is None else np.asarray(cp, np.float32).tolist()


def _deserialize_control_points(data):
    return None if data is None else np.asarray(data, np.float32)


# --------------------------------------------------------------------------
# The transform
# --------------------------------------------------------------------------


class Spatial(SpatialTransform):
    r"""Resample to a target space, apply a world affine and an elastic
    field, all through a single sampling grid.

    Args:
        target: output space: None (the input's), an Image, the name of
            an image in the batch, a ``(shape, affine)`` pair, or a
            spacing spec in mm (a number, an array, a 3-tuple, a range, a
            ``Choice`` or a distribution). A file path raises
            ``NotImplementedError`` (file I/O is not ported).
        scales, degrees, translation: affine parameter specs (see
            :mod:`..parameter_range`).
        isotropic: one scale for all axes.
        center: ``"image"`` or ``"origin"``, the rotation pivot.
        control_points: fixed coarse field (n_i, n_j, n_k, 3) in mm.
        num_control_points: coarse grid size when the field is drawn.
        max_displacement: elastic displacement spec in mm.
        locked_borders: coarse border layers held at zero (0, 1 or 2).
        affine_first: apply the affine before the elastic field.
        image_interpolation: interpolation of scalar images: a name
            ("nearest", "linear", "quadratic", "cubic" or "bspline",
            "fourth" ... "seventh") or an order 0-7.
        label_interpolation: the same for label maps, or "label" for
            partial-volume label resampling.
        one_hot_label_interpolation: interpolation of the one-hot
            channels in "label" mode (not "label" itself).
        antialias: blur images (and one-hot labels in "label" mode)
            before downsampling to the target space.
        default_pad_value: a number, or "minimum", "mean" or "otsu" (per
            element and channel) for scalar images.
        default_pad_label: fill value for label maps.
    """

    def __init__(
        self,
        *,
        target=None,
        scales=1.0,
        degrees=0.0,
        translation=0.0,
        isotropic: bool = False,
        center: str = "image",
        control_points=None,
        num_control_points=7,
        max_displacement=0.0,
        locked_borders: int = 2,
        affine_first: bool = True,
        image_interpolation="linear",
        label_interpolation="nearest",
        one_hot_label_interpolation="linear",
        antialias: bool = False,
        default_pad_value="minimum",
        default_pad_label: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.target = target
        if isotropic and isinstance(scales, (tuple, list)) and len(scales) not in (1, 2):
            raise ValueError(
                "isotropic=True requires a scalar or (lo, hi) range for scales"
            )
        self.scales = _ParameterRange(scales)
        for lo, hi in self.scales._ranges:
            if lo < 0 or hi < 0:
                raise ValueError(f"scales must be non-negative, got {scales}")
        self.degrees = _ParameterRange(degrees)
        self.translation = _ParameterRange(translation)
        self.isotropic = isotropic
        if center not in ("image", "origin"):
            raise ValueError(f'center must be "image" or "origin", got {center!r}')
        self.center = center
        self.control_points = (
            np.asarray(control_points, np.float32) if control_points is not None else None
        )
        if self.control_points is not None and (
            self.control_points.ndim != 4 or self.control_points.shape[-1] != 3
        ):
            raise ValueError(
                "control_points must have shape (n_i, n_j, n_k, 3),"
                f" got {self.control_points.shape}"
            )
        ncp = (
            (int(num_control_points),) * 3
            if isinstance(num_control_points, (int, np.integer))
            else tuple(int(n) for n in num_control_points)
        )
        if any(n < 4 for n in ncp):
            raise ValueError(f"num_control_points must be >= 4, got {ncp}")
        self.num_control_points = ncp
        self.max_displacement = _ParameterRange(max_displacement)
        for lo, hi in self.max_displacement._ranges:
            if lo < 0 or hi < 0:
                raise ValueError(
                    f"max_displacement must be non-negative, got {max_displacement}"
                )
        if locked_borders not in (0, 1, 2):
            raise ValueError(f"locked_borders must be 0, 1, or 2, got {locked_borders}")
        if locked_borders == 2 and 4 in ncp:
            raise ValueError(
                "locked_borders=2 with 4 control points along any axis yields"
                " an identity elastic field"
            )
        self.locked_borders = locked_borders
        self.affine_first = affine_first
        parsed = _parse_interpolation(image_interpolation)
        if parsed == LABEL_INTERPOLATION:
            raise ValueError(
                'image_interpolation cannot be "label"; that mode is only'
                " valid for label_interpolation"
            )
        self.image_interpolation = parsed
        self.label_interpolation = _parse_interpolation(label_interpolation)
        one_hot = _parse_interpolation(one_hot_label_interpolation)
        if one_hot == LABEL_INTERPOLATION:
            raise ValueError('one_hot_label_interpolation cannot be "label"')
        self.one_hot_label_interpolation = one_hot
        self.antialias = antialias
        if isinstance(default_pad_value, str) and default_pad_value not in (
            "minimum",
            "mean",
            "otsu",
        ):
            raise ValueError(f'Unknown default_pad_value "{default_pad_value}"')
        self.default_pad_value = default_pad_value
        if not isinstance(default_pad_label, Number):
            raise TypeError(
                f"default_pad_label must be numeric, got {type(default_pad_label)}"
            )
        self.default_pad_label = float(default_pad_label)

    # --- capabilities ---

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        # shape-changing targets cannot gate per element
        return self.target is None

    # --- sampling ---

    def _sample_scales(self):
        if self.isotropic:
            s = self.scales.sample_1d()
            return (s, s, s)
        return self.scales.sample()

    def _sample_one(self, shape, affine: AffineMatrix):
        scales = self._sample_scales()
        degrees = self.degrees.sample()
        translation = self.translation.sample()
        has_affine = (
            tuple(scales) != (1.0, 1.0, 1.0)
            or tuple(degrees) != (0.0, 0.0, 0.0)
            or tuple(translation) != (0.0, 0.0, 0.0)
        )
        if self.control_points is not None:
            cp = self.control_points.copy()
            disp = _field_displacement_extent(cp)
        else:
            sampled = self.max_displacement.sample()
            if all(v == 0.0 for v in sampled):
                cp, disp = None, None
            else:
                cp = _sample_control_points(
                    self.num_control_points, sampled, self.locked_borders
                )
                disp = sampled
        forward = None
        if has_affine:
            forward = _forward_affine(
                scales=scales,
                degrees=degrees,
                translation=translation,
                center=self.center,
                shape=shape,
                affine=affine,
            )
        return forward, cp, disp, (has_affine or cp is not None)

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        images = self._get_images(batch)
        if not images:
            return {"selected_images": []}
        first = next(iter(images.values()))
        first_shape = tuple(int(s) for s in first.data.shape[-3:])
        first_affine = first.affines[0]
        params: dict[str, Any] = {
            "selected_images": list(images),
            "original": _serialize_space((first_shape, first_affine)),
            "affine_first": self.affine_first,
            "image_interpolation": self.image_interpolation,
            "label_interpolation": self.label_interpolation,
            "one_hot_label_interpolation": self.one_hot_label_interpolation,
            "antialias": self.antialias,
            "default_pad_value": self.default_pad_value,
            "default_pad_label": self.default_pad_label,
        }
        n = self._resolve_n(batch)
        if n is None:
            forward, cp, disp, has_geometry = self._sample_one(first_shape, first_affine)
            if has_geometry:
                _check_shared_space(images, first_shape, first_affine)
            target_space = _resolve_target_space(
                self.target, batch, first_shape, first_affine
            )
            params["target"] = _serialize_space(target_space)
            params["affine_matrix"] = _serialize_matrix(forward)
            params["control_points"] = _serialize_control_points(cp)
            params["max_displacement"] = list(disp) if disp else None
            return params
        keep = self._keep_mask(batch, n)
        affines, cps, disps = [], [], []
        any_geometry = False
        for index in range(n):
            if keep is not None and not keep[index]:
                affines.append(None)
                cps.append(None)
                disps.append(None)
                continue
            forward, cp, disp, has_geometry = self._sample_one(first_shape, first_affine)
            any_geometry = any_geometry or has_geometry
            affines.append(_serialize_matrix(forward))
            cps.append(_serialize_control_points(cp))
            disps.append(list(disp) if disp else None)
        if any_geometry:
            _check_shared_space(images, first_shape, first_affine)
        target_space = _resolve_target_space(
            self.target, batch, first_shape, first_affine
        )
        params["target"] = _serialize_space(target_space)
        params["affine_matrix"] = affines
        params["control_points"] = cps
        params["max_displacement"] = disps
        self._tag_batched(
            params, batch, n, keep,
            ["affine_matrix", "control_points", "max_displacement"],
        )
        return params

    # --- application ---

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        selected = params.get("selected_images", [])
        if not selected:
            return batch
        for key in ("image_interpolation", "label_interpolation"):
            _parse_interpolation(params[key])
        one_hot = _parse_interpolation(params.get("one_hot_label_interpolation", "linear"))
        target_space = _deserialize_space(params["target"])
        per_sample = None
        if "affine_matrix" in (params.get("_batched_keys") or []):
            per_sample = _PerSampleGeometry(
                affines=[_deserialize_matrix(m) for m in params["affine_matrix"]],
                control_points=[
                    _deserialize_control_points(c) for c in params["control_points"]
                ],
                max_displacements=[
                    tuple(d) if d else None for d in params["max_displacement"]
                ],
            )
            affine_matrix = control_points = max_displacement = None
        else:
            affine_matrix = _deserialize_matrix(params["affine_matrix"])
            control_points = _deserialize_control_points(params["control_points"])
            md = params["max_displacement"]
            max_displacement = tuple(md) if md else None
        if (
            target_space is None
            and affine_matrix is None
            and control_points is None
            and per_sample is None
        ):
            return batch
        _run_spatial_pipeline(
            batch=batch,
            image_names=selected,
            target_space=target_space,
            affine_matrix=affine_matrix,
            control_points=control_points,
            max_displacement=max_displacement,
            affine_first=params["affine_first"],
            image_interpolation=params["image_interpolation"],
            label_interpolation=params["label_interpolation"],
            one_hot_label_interpolation=one_hot,
            antialias=params.get("antialias", False),
            default_pad_value=params["default_pad_value"],
            default_pad_label=float(params["default_pad_label"]),
            per_sample=per_sample,
        )
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_SpatialInverse":
        original_space = _deserialize_space(params["original"])
        if original_space is None:
            raise RuntimeError("Spatial inverse needs the original output space")
        common: dict[str, Any] = {
            "target": original_space,
            "affine_first": not params["affine_first"],
            "image_interpolation": params["image_interpolation"],
            "label_interpolation": params["label_interpolation"],
            "one_hot_label_interpolation": params.get(
                "one_hot_label_interpolation", "linear"
            ),
            "default_pad_value": params["default_pad_value"],
            "default_pad_label": float(params["default_pad_label"]),
            "copy": False,
            "include": params["selected_images"],
        }
        if "affine_matrix" in (params.get("_batched_keys") or []):
            per_sample = _PerSampleGeometry(
                affines=[
                    None if m is None else np.linalg.inv(np.asarray(m, np.float64))
                    for m in params["affine_matrix"]
                ],
                control_points=[
                    None if c is None else -np.asarray(c, np.float32)
                    for c in params["control_points"]
                ],
                max_displacements=[
                    tuple(d) if d else None for d in params["max_displacement"]
                ],
            )
            return _SpatialInverse(
                affine_matrix=None, control_points=None, per_sample=per_sample, **common
            )
        affine_matrix = _deserialize_matrix(params["affine_matrix"])
        inverse_affine = None if affine_matrix is None else np.linalg.inv(affine_matrix)
        cp = _deserialize_control_points(params["control_points"])
        return _SpatialInverse(
            affine_matrix=inverse_affine,
            control_points=None if cp is None else -cp,
            **common,
        )


class _PerSampleGeometry:
    """Per-element affines / control points / displacements."""

    def __init__(self, *, affines, control_points, max_displacements):
        self.affines = affines
        self.control_points = control_points
        self.max_displacements = max_displacements

    def __len__(self) -> int:
        return len(self.affines)

    def passthrough_indices(self) -> list[int]:
        return [
            i
            for i in range(len(self.affines))
            if self.affines[i] is None and self.control_points[i] is None
        ]


def _check_shared_space(images, reference_shape, reference_affine) -> None:
    for name, img_batch in images.items():
        shape = tuple(img_batch.data.shape[-3:])
        if shape != tuple(reference_shape):
            raise RuntimeError(
                f'Image "{name}" has spatial shape {shape}, expected'
                f" {tuple(reference_shape)}: spatial transforms need a shared space"
            )
        if not np.allclose(img_batch.affines[0].data, reference_affine.data, atol=1e-5):
            raise RuntimeError(
                f'Image "{name}" has a different affine from the reference'
                " image; spatial transforms need a shared space"
            )


def _run_spatial_pipeline(
    *,
    batch: SubjectsBatch,
    image_names,
    target_space,
    affine_matrix,
    control_points,
    max_displacement,
    affine_first: bool,
    image_interpolation: str,
    label_interpolation: str,
    one_hot_label_interpolation: str,
    antialias: bool,
    default_pad_value,
    default_pad_label: float,
    per_sample: _PerSampleGeometry | None = None,
) -> None:
    """Resample every selected image of ``batch`` through one grid spec
    per element.

    As in the JAX package: the output takes the target's shape and
    affine (the input's without a target); batch-shared geometry builds
    one grid from the first element's affine, per-element geometry one
    grid per element's own input affine, and every output takes the
    output affine. Without a target, elements with no geometry stay
    bit-exact, affine included."""
    if not image_names:
        return
    first = batch.images[image_names[0]]
    input_shape = tuple(first.data.shape[-3:])
    input_affine = first.affines[0]
    output_shape = tuple(target_space[0]) if target_space is not None else input_shape
    output_affine = target_space[1] if target_space is not None else input_affine
    n = first.batch_size
    if per_sample is None:
        grids = [
            _build_grid(
                input_affine=input_affine,
                output_shape=output_shape,
                output_affine=output_affine,
                affine_matrix=affine_matrix,
                control_points=control_points,
                max_displacement=max_displacement,
                affine_first=affine_first,
            )
        ] * n
    else:
        grids = [
            _build_grid(
                input_affine=first.affines[i],
                output_shape=output_shape,
                output_affine=(
                    output_affine if target_space is not None else first.affines[i]
                ),
                affine_matrix=per_sample.affines[i],
                control_points=per_sample.control_points[i],
                max_displacement=per_sample.max_displacements[i],
                affine_first=affine_first,
            )
            for i in range(len(per_sample))
        ]
    maps = [g[0] for g in grids]
    fields = [g[1] for g in grids]
    passthrough = (
        per_sample.passthrough_indices()
        if per_sample is not None and target_space is None
        else []
    )
    keep_original = None
    if passthrough:
        mask = np.zeros(n, bool)
        mask[passthrough] = True
        keep_original = torch.as_tensor(mask, device=first.device).reshape(-1, 1, 1, 1, 1)
    for name in image_names:
        img_batch = batch.images[name]
        data = img_batch.data
        is_label = issubclass(img_batch.image_class, LabelMap)
        interpolation = label_interpolation if is_label else image_interpolation
        if is_label and interpolation == LABEL_INTERPOLATION:
            sampled = _resample_label_partial_volume(
                data, maps, fields, output_shape,
                input_affine=input_affine,
                output_affine=output_affine,
                antialias=antialias,
                one_hot_label_interpolation=one_hot_label_interpolation,
                default_pad_label=default_pad_label,
            )
        else:
            fill = _batch_fill_value(
                img_batch,
                default_pad_value=default_pad_value,
                default_pad_label=default_pad_label,
            )
            source = data
            if antialias and not is_label:
                source = _antialias(data, input_affine, output_affine)
            sampled = _dispatch_resample(
                source, maps, fields, output_shape, mode=interpolation, fill=fill
            )
            # the input dtype comes back after sampling (integer labels
            # stay integer)
            sampled = sampled.to(data.dtype)
        if keep_original is not None:
            sampled = torch.where(keep_original, data.to(sampled.dtype), sampled)
        img_batch.data = sampled
        img_batch.affines = [
            a if i in passthrough else AffineMatrix(output_affine)
            for i, a in enumerate(img_batch.affines)
        ]


def _dispatch_resample(data, maps, fields=None, out_shape=None, *, mode: str, fill):
    """Orders 2-7 through the B-spline path, 0-1 through the
    trilinear/nearest resample; float32 out.

    ``maps`` is either a dense coordinate tensor (a shared (Io, Jo, Ko, 3)
    grid or (B, Io, Jo, Ko, 3) per-element grids; ``fields`` and
    ``out_shape`` unused), routed to :func:`resample` and
    :func:`bspline_resample`, or the length-B list of 4x4 grid-spec maps
    with their coarse ``fields`` and ``out_shape``, routed to the fused
    resamples."""
    order = _INTERPOLATION_TO_ORDER[mode]
    if isinstance(maps, torch.Tensor):
        if order >= 2:
            return bspline_resample(data, maps, order=order, fill=fill)
        return resample(data, maps, mode=mode, fill=fill)
    if order >= 2:
        return bspline_resample_fused(
            data, maps, fields, order=order, out_shape=out_shape, fill=fill
        )
    return resample_fused(data, maps, fields, out_shape=out_shape, mode=mode, fill=fill)


def _resolved_antialias_sigmas(
    input_affine: AffineMatrix, output_affine: AffineMatrix
) -> np.ndarray:
    """Per-axis antialias sigmas for an input -> output space change (the
    one source of both the blur and its no-op test)."""
    in_sp = np.asarray(input_affine.spacing, np.float64)
    out_sp = np.asarray(output_affine.spacing, np.float64)
    return _antialias_sigmas(out_sp / in_sp, in_sp)


def _antialias(data, input_affine: AffineMatrix, output_affine: AffineMatrix):
    sigmas = _resolved_antialias_sigmas(input_affine, output_affine)
    if np.all(sigmas == 0):
        return data
    return gaussian_blur(data, sigmas)


def _resample_label_partial_volume(
    data, maps, fields, out_shape, *, input_affine: AffineMatrix,
    output_affine: AffineMatrix, antialias: bool, one_hot_label_interpolation: str,
    default_pad_label: float,
):
    """Partial-volume label resampling (one-hot + argmax), routed as the
    JAX package routes it:

    - one channel with linear one-hot interpolation and no antialias
      smoothing: the corner vote (:func:`resample_label_fused`), equal to
      the one-hot path;
    - several channels: each channel is resampled as a float map, blurred
      first with ``antialias`` (float labels keep their dtype; integer
      ones come back float32);
    - otherwise the one-hot path over the sorted unique labels (blurred
      first with ``antialias``), ties to the smallest label,
      ``default_pad_label`` where the summed one-hot weight is <= 0.5.
    """
    smoothing = antialias and not np.all(
        _resolved_antialias_sigmas(input_affine, output_affine) == 0
    )
    if data.shape[1] == 1 and not smoothing and one_hot_label_interpolation == "linear":
        return resample_label_fused(
            data, maps, fields, out_shape=out_shape, pad_label=default_pad_label
        )
    if data.shape[1] > 1:
        smoothed = data.to(torch.float32)
        if antialias:
            smoothed = _antialias(smoothed, input_affine, output_affine)
        sampled = _dispatch_resample(
            smoothed, maps, fields, out_shape, mode=one_hot_label_interpolation, fill=0.0,
        )
        return sampled.to(data.dtype) if data.dtype.is_floating_point else sampled
    labels = unique_labels(data)
    values = torch.as_tensor(labels, dtype=data.dtype, device=data.device)
    one_hot = (data[:, 0:1] == values.reshape(1, -1, 1, 1, 1)).to(torch.float32)
    if antialias:
        one_hot = _antialias(one_hot, input_affine, output_affine)
    sampled = _dispatch_resample(
        one_hot, maps, fields, out_shape, mode=one_hot_label_interpolation, fill=0.0
    )
    winners = torch.argmax(sampled, dim=1)
    resampled = torch.as_tensor(labels, dtype=torch.int32, device=data.device)[winners]
    # as in the JAX package, the vote goes through float32 with the pad
    in_bounds = torch.sum(sampled, dim=1) > 0.5
    resampled = torch.where(in_bounds, resampled.to(torch.float32), float(default_pad_label))
    return resampled[:, None].to(data.dtype)


class _SpatialInverse(SpatialTransform):
    """Concrete inverse of Spatial: exact affine inverse, negated elastic
    field, flipped ordering, resample to the recorded original space."""

    def __init__(
        self,
        *,
        target,
        affine_matrix,
        control_points,
        affine_first: bool,
        image_interpolation: str,
        label_interpolation: str,
        one_hot_label_interpolation: str = "linear",
        default_pad_value,
        default_pad_label: float,
        per_sample: _PerSampleGeometry | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.target = target
        self.affine_matrix = (
            None if affine_matrix is None else np.asarray(affine_matrix, np.float64)
        )
        self.control_points = (
            None if control_points is None else np.asarray(control_points, np.float32)
        )
        self.per_sample = per_sample
        self.affine_first = affine_first
        self.image_interpolation = _parse_interpolation(image_interpolation)
        self.label_interpolation = _parse_interpolation(label_interpolation)
        self.one_hot_label_interpolation = _parse_interpolation(
            one_hot_label_interpolation
        )
        self.default_pad_value = default_pad_value
        self.default_pad_label = float(default_pad_label)

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        max_displacement = None
        if self.per_sample is None and self.control_points is not None:
            max_displacement = _field_displacement_extent(self.control_points)
        _run_spatial_pipeline(
            batch=batch,
            image_names=list(self._get_images(batch)),
            target_space=self.target,
            affine_matrix=self.affine_matrix,
            control_points=self.control_points,
            max_displacement=max_displacement,
            affine_first=self.affine_first,
            image_interpolation=self.image_interpolation,
            label_interpolation=self.label_interpolation,
            one_hot_label_interpolation=self.one_hot_label_interpolation,
            antialias=False,
            default_pad_value=self.default_pad_value,
            default_pad_label=self.default_pad_label,
            per_sample=self.per_sample,
        )
        return batch


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------


class Resample(Spatial):
    r"""Resample images to another space (by default 1 mm isotropic)."""

    def __init__(
        self,
        *,
        target=1.0,
        image_interpolation="linear",
        label_interpolation="nearest",
        one_hot_label_interpolation="linear",
        antialias: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            target=target,
            image_interpolation=image_interpolation,
            label_interpolation=label_interpolation,
            one_hot_label_interpolation=one_hot_label_interpolation,
            antialias=antialias,
            **kwargs,
        )


class Affine(Spatial):
    r"""Random affine: scales / degrees / translation about a pivot."""

    def __init__(
        self,
        *,
        scales=1.0,
        degrees=0.0,
        translation=0.0,
        isotropic: bool = False,
        center: str = "image",
        default_pad_value="minimum",
        default_pad_label: float = 0,
        image_interpolation="linear",
        label_interpolation="nearest",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            scales=scales,
            degrees=degrees,
            translation=translation,
            isotropic=isotropic,
            center=center,
            default_pad_value=default_pad_value,
            default_pad_label=default_pad_label,
            image_interpolation=image_interpolation,
            label_interpolation=label_interpolation,
            **kwargs,
        )


class ElasticDeformation(Spatial):
    r"""Random dense elastic deformation from a coarse control grid."""

    def __init__(
        self,
        *,
        control_points=None,
        num_control_points=7,
        max_displacement=7.5,
        locked_borders: int = 2,
        image_interpolation="linear",
        label_interpolation="nearest",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            control_points=control_points,
            num_control_points=num_control_points,
            max_displacement=max_displacement,
            locked_borders=locked_borders,
            image_interpolation=image_interpolation,
            label_interpolation=label_interpolation,
            **kwargs,
        )
