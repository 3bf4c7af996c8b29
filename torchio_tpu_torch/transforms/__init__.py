from .compose import Compose
from .intensity.bias_field import BiasField
from .intensity.blur import Blur
from .intensity.gamma import Gamma
from .intensity.ghosting import Ghosting
from .intensity.motion import Motion
from .intensity.noise import Noise
from .intensity.normalize import Normalize, RescaleIntensity
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
    "Compose",
    "Crop",
    "CropOrPad",
    "ElasticDeformation",
    "EnsureShapeMultiple",
    "Flip",
    "Gamma",
    "Ghosting",
    "IntensityTransform",
    "Motion",
    "Noise",
    "Normalize",
    "Pad",
    "Resample",
    "RescaleIntensity",
    "Spatial",
    "SpatialTransform",
    "Transform",
    "apply_inverse_transform",
    "get_inverse_transform",
]
