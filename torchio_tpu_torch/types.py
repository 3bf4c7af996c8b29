"""Type aliases (the port's counterparts of ``torchio_tpu/types.py``):
image data is a torch tensor (or host numpy), affines are float64 numpy
on the host."""

from __future__ import annotations

import os
from typing import Callable, Sequence, Union

import numpy as np
import torch

# Path-like inputs accepted by Image and the I/O functions.
TypePath = Union[str, os.PathLike]

# Image data: (C, I, J, K), a tensor or host numpy.
TypeImageData = Union[torch.Tensor, np.ndarray]

# 4x4 voxel-to-world matrix (float64 numpy on the host).
TypeAffineMatrix = np.ndarray

# Spacing in mm along each voxel axis.
TypeSpacing = tuple[float, float, float]

# World coordinates of the first voxel center.
TypeOrigin = tuple[float, float, float]

# 3x3 direction (rotation) matrix.
TypeDirection = np.ndarray

# Anatomical orientation codes, e.g. ('R', 'A', 'S').
TypeOrientationCodes = tuple[str, str, str]

# Spatial shape (I, J, K).
TypeSpatialShape = tuple[int, int, int]

# Full tensor shape (C, I, J, K).
TypeTensorShape = tuple[int, int, int, int]

# (N, 3) world-space points.
TypeWorldPoints = Union[torch.Tensor, np.ndarray]

# Scalar or per-axis numeric specs used throughout the transforms.
TypeNumber = Union[int, float]
TypeTripletInt = tuple[int, int, int]
TypeTripletFloat = tuple[float, float, float]
TypeSextetInt = tuple[int, int, int, int, int, int]
TypeRangeFloat = Union[float, tuple[float, float]]

TypeDataAffine = tuple[TypeImageData, TypeAffineMatrix]

TypeCallable = Callable

TypeKeys = Union[Sequence[str], None]
