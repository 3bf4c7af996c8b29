from .batch import ImagesBatch, SubjectsBatch
from .image import Image, LabelMap, ScalarImage
from .subject import Subject

__all__ = [
    "Image",
    "ImagesBatch",
    "LabelMap",
    "ScalarImage",
    "Subject",
    "SubjectsBatch",
]
