from .compose import Compose
from .intensity.bias_field import BiasField
from .intensity.blur import Blur
from .intensity.gamma import Gamma
from .intensity.ghosting import Ghosting
from .intensity.motion import Motion
from .intensity.noise import Noise
from .intensity.normalize import Normalize, RescaleIntensity
from .parameter_range import Choice
from .spatial.flip import Flip
from .spatial.spatial import Affine, ElasticDeformation, Spatial
from .transform import IntensityTransform, SpatialTransform, Transform

__all__ = [
    "Affine",
    "BiasField",
    "Blur",
    "Choice",
    "Compose",
    "ElasticDeformation",
    "Flip",
    "Gamma",
    "Ghosting",
    "IntensityTransform",
    "Motion",
    "Noise",
    "Normalize",
    "RescaleIntensity",
    "Spatial",
    "SpatialTransform",
    "Transform",
]
