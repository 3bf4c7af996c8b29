"""torchio_tpu_torch: the PyTorch / CUDA port of torchio_tpu.

3D medical image augmentation on torch tensors: volumes are (C, I, J, K)
tensors with RAS+ affine metadata, batches are (B, C, I, J, K) tensors,
and a batch runs on the device its tensors live on. The JAX package
``torchio_tpu`` is the reference this port is held against; the two
packages draw identical parameters from the same :func:`seed`.

It covers the headline augmentation pipeline,
``Compose([Spatial(...), BiasField(...), Noise(...)], fuse=True)``, with
every interpolation of ``Spatial`` (nearest, linear, B-spline orders 2-7
and the partial-volume "label" mode); the MRI-artifact pair
``Compose([Motion(...), Ghosting(...)])``; and Flip,
Normalize/RescaleIntensity, Blur and Gamma. On a CUDA batch the
resampling and the random fields run in hand-written CUDA kernels
(``csrc/``); on a CPU batch in their plain PyTorch versions. The random
fields are ``jax.random``'s own threefry draws, so one seed gives the
JAX package's noise and bias fields. The dense-coordinate entry
(``ops.resample``, ``ops.build_coords``) serves Motion's rigid moves.

Host data (numpy arrays) given to an image, a subject, or a transform's
ndarray or dict entry lands on the card; :func:`set_default_device`
(``"cpu"``) asks for the CPU instead.
"""

__version__ = "0.1.0"

from . import random  # noqa: A004  (named like the stdlib on purpose)
from .config import default_device, set_default_device
from .core.affine import AffineMatrix
from .data import ImagesBatch, LabelMap, ScalarImage, Subject, SubjectsBatch
from .random import seed
from .transforms import (
    Affine,
    BiasField,
    Blur,
    Choice,
    Compose,
    ElasticDeformation,
    Flip,
    Gamma,
    Ghosting,
    Motion,
    Noise,
    Normalize,
    RescaleIntensity,
    Spatial,
)

__all__ = [
    "Affine",
    "AffineMatrix",
    "BiasField",
    "Blur",
    "Choice",
    "Compose",
    "ElasticDeformation",
    "Flip",
    "Gamma",
    "Ghosting",
    "ImagesBatch",
    "LabelMap",
    "Motion",
    "Noise",
    "Normalize",
    "RescaleIntensity",
    "ScalarImage",
    "Spatial",
    "Subject",
    "SubjectsBatch",
    "default_device",
    "random",
    "seed",
    "set_default_device",
]
