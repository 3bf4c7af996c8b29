from .compose import Compose, OneOf, SomeOf
from .intensity.bias_field import BiasField
from .intensity.blur import Blur
from .intensity.clamp import Clamp
from .intensity.gamma import Gamma
from .intensity.ghosting import Ghosting
from .intensity.histogram_standardization import (
    HistogramStandardization,
    compute_histogram_landmarks,
)
from .intensity.labels_to_image import LabelsToImage
from .intensity.mask import Mask
from .intensity.motion import Motion
from .intensity.noise import Noise
from .intensity.normalize import Normalize, RescaleIntensity
from .intensity.pca import PCA
from .intensity.spike import Spike
from .intensity.standardize import Standardize, ZNormalization
from .intensity.swap import Swap
from .label.contour import Contour
from .label.keep_largest import KeepLargestComponent
from .label.one_hot import OneHot
from .label.remap_labels import RemapLabels, RemoveLabels
from .label.sequential_labels import SequentialLabels
from .lambda_transform import Lambda
from .parameter_range import Choice
from .inverse import apply_inverse_transform, get_inverse_transform
from .spatial.anisotropy import Anisotropy
from .spatial.crop import Crop
from .spatial.crop_or_pad import CropOrPad, EnsureShapeMultiple
from .spatial.flip import Flip
from .spatial.pad import Pad
from .spatial.reorient import Reorient
from .spatial.resize import Resize
from .spatial.spatial import Affine, ElasticDeformation, Resample, Spatial
from .spatial.to_reference_space import ToReferenceSpace
from .spatial.transpose import CopyAffine, Transpose
from .to import To
from .transform import AppliedTransform, IntensityTransform, SpatialTransform, Transform

__all__ = [
    "Affine",
    "Anisotropy",
    "AppliedTransform",
    "BiasField",
    "Blur",
    "Choice",
    "Clamp",
    "Compose",
    "Contour",
    "CopyAffine",
    "Crop",
    "CropOrPad",
    "ElasticDeformation",
    "EnsureShapeMultiple",
    "Flip",
    "Gamma",
    "Ghosting",
    "HistogramStandardization",
    "IntensityTransform",
    "KeepLargestComponent",
    "LabelsToImage",
    "Lambda",
    "Mask",
    "Motion",
    "Noise",
    "Normalize",
    "OneHot",
    "OneOf",
    "PCA",
    "Pad",
    "RemapLabels",
    "RemoveLabels",
    "Reorient",
    "Resample",
    "RescaleIntensity",
    "Resize",
    "SequentialLabels",
    "SomeOf",
    "Spatial",
    "SpatialTransform",
    "Spike",
    "Standardize",
    "Swap",
    "To",
    "ToReferenceSpace",
    "Transform",
    "Transpose",
    "ZNormalization",
    "apply_inverse_transform",
    "compute_histogram_landmarks",
    "get_inverse_transform",
]
