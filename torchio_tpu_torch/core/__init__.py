from .affine import AffineMatrix, affine_to_orientation, orientation_codes
from .axes import ANATOMICAL_PAIRS, AxesType, axes_type, get_axis_mapping, validate_axes

__all__ = [
    "ANATOMICAL_PAIRS",
    "AffineMatrix",
    "AxesType",
    "affine_to_orientation",
    "axes_type",
    "get_axis_mapping",
    "orientation_codes",
    "validate_axes",
]
