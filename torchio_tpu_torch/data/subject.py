"""Subject: a dict-like collection of images, annotations and metadata.

Counterpart of ``torchio_tpu/data/subject.py``: keyword arguments are
split into images, point sets, bounding boxes and metadata, with
attribute and key access and consistency checks. :meth:`Subject.load`
and :meth:`Subject.unload` load and drop every image's voxels (an image
read from a file stays lazy until then). ``Study`` is another name of
``Subject``. Spatial slicing of a whole subject comes later.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Iterator

import numpy as np

from .bboxes import BoundingBoxes
from .image import Image, ScalarImage
from .invertible import Invertible
from .points import Points


class Subject(Invertible):
    """A study: named images, point sets, bounding boxes, and metadata.

    Examples:
        >>> from torchio_tpu_torch.data.image import ScalarImage
        >>> subject = Subject(t1=ScalarImage(np.zeros((1, 4, 4, 4))), age=45)
        >>> subject.t1.spatial_shape
        (4, 4, 4)
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        if args:
            if len(args) > 1 or not isinstance(args[0], dict):
                raise ValueError("Subject accepts a single dict or keyword arguments")
            kwargs = {**args[0], **kwargs}
        images: dict[str, Image] = {}
        points: dict[str, Points] = {}
        bboxes: dict[str, BoundingBoxes] = {}
        metadata: dict[str, Any] = {}
        for k, v in kwargs.items():
            if isinstance(v, Image):
                images[k] = v
            elif isinstance(v, Points):
                points[k] = v
            elif isinstance(v, BoundingBoxes):
                bboxes[k] = v
            else:
                metadata[k] = v
        if not (images or points or bboxes or metadata):
            raise ValueError("A Subject must contain at least one entry")
        self._images = images
        self._points = points
        self._bounding_boxes = bboxes
        self._metadata = metadata
        self.applied_transforms: list[Any] = []

    # --- Access ---

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        d = self.__dict__
        for store_name in ("_images", "_points", "_bounding_boxes", "_metadata"):
            store = d.get(store_name)
            if store and name in store:
                return store[name]
        raise AttributeError(f"Subject has no entry {name!r}")

    def _spatial_stores(self) -> tuple[dict, dict, dict]:
        return (self._images, self._points, self._bounding_boxes)

    def __getitem__(self, item: str) -> Any:
        # string lookup covers the spatial stores (images, points, boxes);
        # metadata is attribute-style or ``subject.metadata[...]``
        for store in self._spatial_stores():
            if item in store:
                return store[item]
        raise KeyError(item)

    def __setitem__(self, key: str, value: Any) -> None:
        for store in (*self._spatial_stores(), self._metadata):
            store.pop(key, None)
        if isinstance(value, Image):
            self._images[key] = value
        elif isinstance(value, Points):
            self._points[key] = value
        elif isinstance(value, BoundingBoxes):
            self._bounding_boxes[key] = value
        else:
            self._metadata[key] = value

    def __delitem__(self, key: str) -> None:
        for store in (*self._spatial_stores(), self._metadata):
            if key in store:
                del store[key]
                return
        raise KeyError(key)

    # iteration, length and membership cover the spatial entries only
    def __contains__(self, name: object) -> bool:
        return any(name in store for store in self._spatial_stores())

    def __iter__(self) -> Iterator[str]:
        for store in self._spatial_stores():
            yield from store

    def __len__(self) -> int:
        return sum(len(store) for store in self._spatial_stores())

    def keys(self):
        return list(iter(self))

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]

    # --- Properties ---

    @property
    def metadata(self) -> dict[str, Any]:
        return self._metadata

    @property
    def images(self) -> dict[str, Image]:
        return self._images

    @property
    def points(self) -> dict[str, Points]:
        return self._points

    @property
    def bounding_boxes(self) -> dict[str, BoundingBoxes]:
        return self._bounding_boxes

    @property
    def spatial_shape(self) -> tuple[int, int, int]:
        self._check_consistent_attribute("spatial_shape")
        return self._first_image.spatial_shape

    @property
    def shape(self) -> tuple[int, int, int, int]:
        self._check_consistent_attribute("shape")
        return self._first_image.shape

    @property
    def spacing(self) -> tuple[float, float, float]:
        self._check_consistent_attribute("spacing")
        return self._first_image.spacing

    @property
    def device(self):
        return self._first_image.device

    @property
    def _first_image(self) -> Image:
        if not self._images:
            raise RuntimeError("Subject contains no images")
        return next(iter(self._images.values()))

    def get_images(self, intensity_only: bool = True, include=None, exclude=None) -> list[Image]:
        """Images filtered by type and name (transform scoping helper)."""
        return list(self.get_images_dict(intensity_only, include, exclude).values())

    def get_images_dict(
        self, intensity_only: bool = True, include=None, exclude=None
    ) -> dict[str, Image]:
        """``{name: image}`` of the images kept by :meth:`get_images`'s
        filters: ``include`` and ``exclude`` name lists, and ScalarImages
        only when ``intensity_only``."""
        out = {}
        for name, image in self._images.items():
            if include is not None and name not in include:
                continue
            if exclude is not None and name in exclude:
                continue
            if intensity_only and not isinstance(image, ScalarImage):
                continue
            out[name] = image
        return out

    # --- Annotations ---

    def all_points(self) -> dict[Any, Points]:
        """Subject-level and per-image point sets, keyed by name or (img, name)."""
        out: dict[Any, Points] = dict(self._points)
        for img_name, image in self._images.items():
            for pname, pts in image.points.items():
                out[(img_name, pname)] = pts
        return out

    def all_bounding_boxes(self) -> dict[Any, BoundingBoxes]:
        out: dict[Any, BoundingBoxes] = dict(self._bounding_boxes)
        for img_name, image in self._images.items():
            for bname, boxes in image.bounding_boxes.items():
                out[(img_name, bname)] = boxes
        return out

    # --- Behavior ---

    def load(self) -> None:
        for image in self._images.values():
            image.load()

    def unload(self) -> None:
        for image in self._images.values():
            image.unload()

    def to(self, device: Any = None, dtype: Any = None) -> "Subject":
        for image in self._images.values():
            image.to(device, dtype)
        return self

    def check_consistent_spatial_shape(self) -> None:
        self._check_consistent_attribute("spatial_shape")

    def check_consistent_space(self) -> None:
        self._check_consistent_attribute("spatial_shape")
        self._check_consistent_attribute("spacing")

    def _check_consistent_attribute(self, attribute: str, rel_tol: float = 1e-6) -> None:
        if len(self._images) <= 1:
            return
        names = list(self._images)
        first = getattr(self._images[names[0]], attribute)
        for name in names[1:]:
            value = getattr(self._images[name], attribute)
            same = (
                np.allclose(value, first, rtol=rel_tol)
                if isinstance(first, tuple) and first and isinstance(first[0], float)
                else value == first
            )
            if not same:
                raise RuntimeError(
                    f"Inconsistent {attribute} across images:"
                    f" {names[0]}={first}, {name}={value}"
                )

    # --- Copy & repr ---

    def __copy__(self) -> "Subject":
        return self.__deepcopy__({})

    def __deepcopy__(self, memo: dict) -> "Subject":
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new._images = {k: _copy.deepcopy(v, memo) for k, v in self._images.items()}
        new._points = {k: _copy.deepcopy(v, memo) for k, v in self._points.items()}
        new._bounding_boxes = {
            k: _copy.deepcopy(v, memo) for k, v in self._bounding_boxes.items()
        }
        new._metadata = _copy.deepcopy(self._metadata, memo)
        new.applied_transforms = list(self.applied_transforms)
        return new

    def plot(self, **kwargs: Any) -> Any:
        """Plot all images, one row of three planes each."""
        from ..visualization import plot_subject

        return plot_subject(self, **kwargs)

    def _repr_html_(self) -> str:
        from ..repr_html import subject_repr_html

        return subject_repr_html(self)

    def __repr__(self) -> str:
        parts = []
        if self._images:
            parts.append(f"images: {tuple(self._images)}")
        if self._points:
            parts.append(f"points: {tuple(self._points)}")
        if self._bounding_boxes:
            parts.append(f"bounding_boxes: {tuple(self._bounding_boxes)}")
        if self._metadata:
            parts.append(f"metadata: {tuple(self._metadata)}")
        return f"Subject({'; '.join(parts)})"


Study = Subject
