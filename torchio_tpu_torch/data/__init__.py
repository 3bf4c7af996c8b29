from .aggregator import PatchAggregator
from .batch import ImagesBatch, StudiesBatch, SubjectsBatch
from .bboxes import BoundingBoxes, BoundingBoxFormat, Representation
from .image import Image, LabelMap, ScalarImage
from .loader import (
    ImagesLoader,
    StudiesLoader,
    SubjectsLoader,
    collate_images,
    collate_studies,
    collate_subjects,
)
from .patch import PatchLocation
from .points import Points
from .queue import Queue
from .sampler import (
    GridSampler,
    LabelSampler,
    PatchSampler,
    UniformSampler,
    WeightedSampler,
)
from .subject import Study, Subject

__all__ = [
    "BoundingBoxFormat",
    "BoundingBoxes",
    "GridSampler",
    "Image",
    "ImagesBatch",
    "ImagesLoader",
    "LabelMap",
    "LabelSampler",
    "PatchAggregator",
    "PatchLocation",
    "PatchSampler",
    "Points",
    "Queue",
    "Representation",
    "ScalarImage",
    "StudiesBatch",
    "StudiesLoader",
    "Study",
    "Subject",
    "SubjectsBatch",
    "SubjectsLoader",
    "UniformSampler",
    "WeightedSampler",
    "collate_images",
    "collate_studies",
    "collate_subjects",
]
