from .compose import Compose
from .intensity.bias_field import BiasField
from .intensity.ghosting import Ghosting
from .intensity.motion import Motion
from .intensity.noise import Noise
from .parameter_range import Choice
from .spatial.spatial import Affine, ElasticDeformation, Spatial
from .transform import IntensityTransform, SpatialTransform, Transform

__all__ = [
    "Affine",
    "BiasField",
    "Choice",
    "Compose",
    "ElasticDeformation",
    "Ghosting",
    "IntensityTransform",
    "Motion",
    "Noise",
    "Spatial",
    "SpatialTransform",
    "Transform",
]
