"""Histogram standardization (Nyúl & Udupa 1999).

Counterpart of ``torchio_tpu/transforms/intensity/histogram_standardization.py``:
:func:`compute_histogram_landmarks` averages the percentile curves of a
training corpus mapped to [0, 100] by linear regression (host numpy);
:class:`HistogramStandardization` maps each element piecewise-linearly
onto the landmarks. The element's exact quantiles are computed on its
device and only those scalars reach the host, which computes each
segment's slope and intercept; ``torch.searchsorted`` picks each voxel's
segment on the device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ...data.batch import SubjectsBatch
from ...data.image import Image, ScalarImage
from .._statistics import quantiles_on_device
from ..transform import IntensityTransform

DEFAULT_CUTOFF: tuple[float, float] = (0.01, 0.99)
STANDARD_RANGE: tuple[float, float] = (0.0, 100.0)

_DEFAULT_QUANTILES: tuple[float, ...] = (
    0.01, 0.10, 0.20, 0.25, 0.30, 0.40, 0.50,
    0.60, 0.70, 0.75, 0.80, 0.90, 0.99,
)


def _build_quantiles(cutoff: tuple[float, float]) -> tuple[float, ...]:
    raw = set(_DEFAULT_QUANTILES) | {cutoff[0], cutoff[1]}
    return tuple(sorted(raw))


def _host_volume(source: Any) -> np.ndarray:
    """(C, I, J, K) float32 host copy of an image, a path, a tensor or an
    array; a file (or an image not loaded yet) is read on the host and not
    sent to a device."""
    if isinstance(source, (str, Path)):
        source = ScalarImage(source)
    if isinstance(source, Image):
        source = source.data if source.is_loaded else source.dataobj.to_array()
    if isinstance(source, torch.Tensor):
        source = source.detach().cpu().numpy()
    volume = np.asarray(source, np.float32)
    return volume[None] if volume.ndim == 3 else volume


def compute_histogram_landmarks(
    images: Sequence[Any],
    *,
    quantiles: Sequence[float] | None = None,
    cutoff: tuple[float, float] = DEFAULT_CUTOFF,
    masking_method: Callable | None = None,
) -> np.ndarray:
    """Average percentile landmarks over a training corpus of images,
    paths (read as :class:`ScalarImage`), tensors or arrays;
    ``masking_method`` gets each (C, I, J, K) host array.

    Returns a 1D float32 array usable with
    :class:`HistogramStandardization`.
    """
    if quantiles is None:
        quantiles = _build_quantiles(cutoff)
    else:
        quantiles = tuple(sorted(set(quantiles)))
    if len(quantiles) < 2:
        raise ValueError(f"Need at least 2 quantiles, got {len(quantiles)}")
    if any(q < 0 or q > 1 for q in quantiles):
        raise ValueError(f"Quantiles must be in [0, 1], got {quantiles}")
    percentiles = [100.0 * q for q in quantiles]
    rows = []
    for source in images:
        tensor = _host_volume(source)
        values = (
            tensor[np.asarray(masking_method(tensor), bool)]
            if masking_method is not None
            else tensor.reshape(-1)
        )
        rows.append(np.percentile(values, percentiles))
    database = np.vstack(rows)
    pc_low, pc_high = database[:, 0], database[:, -1]
    s_low, s_high = STANDARD_RANGE
    slopes = np.nan_to_num((s_high - s_low) / (pc_high - pc_low))
    intercept = float(np.mean(s_low - slopes * pc_low))
    mapping = slopes @ database / len(database) + intercept
    return mapping.astype(np.float32)


def _load_landmarks(source) -> np.ndarray:
    """Landmarks from an array-like, a tensor or a ``.npy`` / ``.pt`` /
    ``.pth`` file."""
    if isinstance(source, torch.Tensor):
        return source.detach().cpu().numpy().astype(np.float32)
    if isinstance(source, (np.ndarray, list, tuple)) or hasattr(source, "__array__"):
        return np.asarray(source, np.float32)
    path = Path(source)
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    if path.suffix in (".pt", ".pth"):
        data = torch.load(path, weights_only=True)
        if not isinstance(data, torch.Tensor):
            raise TypeError(
                f"Expected a tensor in {path}, got {type(data).__name__}"
            )
        return data.numpy().astype(np.float32)
    raise ValueError(f"Unsupported landmarks source: {source!r}")


class HistogramStandardization(IntensityTransform):
    r"""Piecewise-linear histogram mapping onto trained landmarks.

    Each instance targets one modality; compose several with ``include``
    for multi-modal subjects.
    """

    def __init__(
        self,
        landmarks,
        *,
        cutoff: tuple[float, float] = DEFAULT_CUTOFF,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.landmarks = _load_landmarks(landmarks)
        self.cutoff = cutoff

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in self._get_images(batch).values():
            data = img_batch.data
            out = [
                _standardize(data[i], self.landmarks, self.cutoff)
                for i in range(data.shape[0])
            ]
            img_batch.data = torch.stack(out)
        return batch


def _standardize(tensor: torch.Tensor, landmarks: np.ndarray, cutoff) -> torch.Tensor:
    """One (C, I, J, K) element mapped onto ``landmarks``, in float32."""
    quantiles = _build_quantiles(cutoff)
    percentiles = [100.0 * q for q in quantiles]
    if len(landmarks) != len(percentiles):
        raise ValueError(
            f"Number of landmarks ({len(landmarks)}) does not match the"
            f" number of quantile positions ({len(percentiles)}); ensure the"
            " same quantile scheme was used for training."
        )
    data = tensor.to(torch.float32)
    flat = data.reshape(-1)
    # only the landmark scalars leave the device
    input_landmarks = quantiles_on_device(flat, quantiles).cpu().numpy()
    lm = landmarks.astype(np.float32)
    diff_lm = np.diff(lm)
    diff_in = np.diff(input_landmarks)
    diff_in = np.where(np.abs(diff_in) < 1e-5, np.inf, diff_in)
    slopes = diff_lm / diff_in
    intercepts = lm[:-1] - slopes * input_landmarks[:-1]
    dev = data.device
    edges = torch.as_tensor(input_landmarks[1:-1], device=dev)
    bins = torch.searchsorted(edges, flat, right=True)
    slope = torch.as_tensor(slopes, device=dev)[bins]
    intercept = torch.as_tensor(intercepts, device=dev)[bins]
    return (slope * flat + intercept).reshape(data.shape)
