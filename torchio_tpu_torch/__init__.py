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
``Compose([Motion(...), Ghosting(...)])``; Flip,
Normalize/RescaleIntensity, Blur, Gamma, Clamp, Standardize
(ZNormalization) and Mask; OneOf and SomeOf (``t1 | t2`` builds a
OneOf), per instance with per-element histories; point sets and
bounding boxes carried by images and subjects; target spaces (Resample,
``Spatial(target=...)``), Pad, Crop, CropOrPad and EnsureShapeMultiple;
and the inverse of a recorded history (:func:`get_inverse_transform`,
``apply_inverse_transform()`` on an image, a subject or a batch). On a
CUDA batch the resampling and the random fields run in hand-written
CUDA kernels (``csrc/``); on a CPU batch in their plain PyTorch
versions. The random
fields are ``jax.random``'s own threefry draws, so one seed gives the
JAX package's noise and bias fields. The dense-coordinate entry
(``ops.resample``, ``ops.build_coords``) serves Motion's rigid moves.

The patch layer between the transforms and a training or inference loop
(BASELINE.json config 5): the samplers (GridSampler, UniformSampler,
WeightedSampler, LabelSampler), the Queue (with ``device_batches``, ring
buffers of patches on the device), the loaders and collate functions,
and the PatchAggregator (crop, average and hann reassembly); Spike joins
Motion and Ghosting as the third k-space artifact.

Host data (numpy arrays) given to an image, a subject, or a transform's
ndarray or dict entry lands on the card; :func:`set_default_device`
(``"cpu"``) asks for the CPU instead.
"""

__version__ = "0.1.0"

from . import random  # noqa: A004  (named like the stdlib on purpose)
from .config import default_device, set_default_device
from .core.affine import AffineMatrix
from .data import (
    BoundingBoxes,
    BoundingBoxFormat,
    GridSampler,
    ImagesBatch,
    ImagesLoader,
    LabelMap,
    LabelSampler,
    PatchAggregator,
    PatchLocation,
    PatchSampler,
    Points,
    Queue,
    Representation,
    ScalarImage,
    StudiesLoader,
    Subject,
    SubjectsBatch,
    SubjectsLoader,
    UniformSampler,
    WeightedSampler,
    collate_images,
    collate_studies,
    collate_subjects,
)
from .random import seed
from .transforms import (
    Affine,
    BiasField,
    Blur,
    Choice,
    Clamp,
    Compose,
    Crop,
    CropOrPad,
    ElasticDeformation,
    EnsureShapeMultiple,
    Flip,
    Gamma,
    Ghosting,
    Mask,
    Motion,
    Noise,
    Normalize,
    OneOf,
    Pad,
    Resample,
    RescaleIntensity,
    SomeOf,
    Spatial,
    Spike,
    Standardize,
    ZNormalization,
    apply_inverse_transform,
    get_inverse_transform,
)

__all__ = [
    "Affine",
    "AffineMatrix",
    "BiasField",
    "Blur",
    "BoundingBoxFormat",
    "BoundingBoxes",
    "Choice",
    "Clamp",
    "Compose",
    "Crop",
    "CropOrPad",
    "ElasticDeformation",
    "EnsureShapeMultiple",
    "Flip",
    "Gamma",
    "Ghosting",
    "GridSampler",
    "ImagesBatch",
    "ImagesLoader",
    "LabelMap",
    "LabelSampler",
    "Mask",
    "Motion",
    "Noise",
    "Normalize",
    "OneOf",
    "Pad",
    "PatchAggregator",
    "PatchLocation",
    "PatchSampler",
    "Points",
    "Queue",
    "Representation",
    "Resample",
    "RescaleIntensity",
    "ScalarImage",
    "SomeOf",
    "Spatial",
    "Spike",
    "Standardize",
    "StudiesLoader",
    "Subject",
    "SubjectsBatch",
    "SubjectsLoader",
    "UniformSampler",
    "WeightedSampler",
    "ZNormalization",
    "apply_inverse_transform",
    "collate_images",
    "collate_studies",
    "collate_subjects",
    "default_device",
    "get_inverse_transform",
    "random",
    "seed",
    "set_default_device",
]
