from .compose import Compose, OneOf, SomeOf
from .intensity.bias_field import BiasField
from .intensity.blur import Blur
from .intensity.clamp import Clamp
from .intensity.gamma import Gamma
from .intensity.ghosting import Ghosting
from .intensity.mask import Mask
from .intensity.motion import Motion
from .intensity.noise import Noise
from .intensity.normalize import Normalize, RescaleIntensity
from .intensity.spike import Spike
from .intensity.standardize import Standardize, ZNormalization
from .parameter_range import Choice
from .inverse import apply_inverse_transform, get_inverse_transform
from .spatial.crop import Crop
from .spatial.crop_or_pad import CropOrPad, EnsureShapeMultiple
from .spatial.flip import Flip
from .spatial.pad import Pad
from .spatial.spatial import Affine, ElasticDeformation, Resample, Spatial
from .transform import IntensityTransform, SpatialTransform, Transform

__all__ = [
    "Affine",
    "BiasField",
    "Blur",
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
    "IntensityTransform",
    "Mask",
    "Motion",
    "Noise",
    "Normalize",
    "OneOf",
    "Pad",
    "Resample",
    "RescaleIntensity",
    "SomeOf",
    "Spatial",
    "SpatialTransform",
    "Spike",
    "Standardize",
    "Transform",
    "ZNormalization",
    "apply_inverse_transform",
    "get_inverse_transform",
]
