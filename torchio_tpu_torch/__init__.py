"""torchio_tpu_torch: the PyTorch / CUDA port of torchio_tpu.

3D medical image augmentation on torch tensors: volumes are (C, I, J, K)
tensors with RAS+ affine metadata, batches are (B, C, I, J, K) tensors,
and a batch runs on the device its tensors live on. The JAX package
``torchio_tpu`` is the reference this port is held against; the two
packages draw identical parameters from the same :func:`seed`.

It covers the headline augmentation pipeline,
``Compose([Spatial(...), BiasField(...), Noise(...)], fuse=True)``, with
every interpolation of ``Spatial`` (nearest, linear, B-spline orders 2-7
and the partial-volume "label" mode), and the MRI-artifact pair
``Compose([Motion(...), Ghosting(...)])``. On a CUDA batch the resampling
runs in hand-written CUDA kernels (``csrc/``); on a CPU batch in their
plain PyTorch versions. The dense-coordinate entry (``ops.resample``,
``ops.build_coords``) serves Motion's rigid moves.
"""

__version__ = "0.1.0"

from . import random  # noqa: A004  (named like the stdlib on purpose)
from .core.affine import AffineMatrix
from .data import ImagesBatch, LabelMap, ScalarImage, Subject, SubjectsBatch
from .random import seed
from .transforms import (
    Affine,
    BiasField,
    Choice,
    Compose,
    ElasticDeformation,
    Ghosting,
    Motion,
    Noise,
    Spatial,
)

__all__ = [
    "Affine",
    "AffineMatrix",
    "BiasField",
    "Choice",
    "Compose",
    "ElasticDeformation",
    "Ghosting",
    "ImagesBatch",
    "LabelMap",
    "Motion",
    "Noise",
    "ScalarImage",
    "Spatial",
    "Subject",
    "SubjectsBatch",
    "random",
    "seed",
]
