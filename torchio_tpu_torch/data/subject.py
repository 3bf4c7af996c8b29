"""Subject: a dict-like collection of images plus metadata.

Counterpart of ``torchio_tpu/data/subject.py`` for in-memory images:
keyword arguments are split into images and metadata, with attribute and
key access and consistency checks. Points, bounding boxes and spatial
slicing come later.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Iterator

import numpy as np

from .image import Image
from .invertible import Invertible


class Subject(Invertible):
    """A study: named images and metadata.

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
        if not kwargs:
            raise ValueError("A Subject must contain at least one entry")
        self._images: dict[str, Image] = {
            k: v for k, v in kwargs.items() if isinstance(v, Image)
        }
        self._metadata: dict[str, Any] = {
            k: v for k, v in kwargs.items() if not isinstance(v, Image)
        }
        self.applied_transforms: list[Any] = []

    # --- Access ---

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        d = self.__dict__
        for store_name in ("_images", "_metadata"):
            store = d.get(store_name)
            if store and name in store:
                return store[name]
        raise AttributeError(f"Subject has no entry {name!r}")

    def __getitem__(self, item: str) -> Image:
        # string lookup covers images only; metadata is attribute-style
        # or ``subject.metadata[...]``
        return self._images[item]

    def __setitem__(self, key: str, value: Any) -> None:
        self._images.pop(key, None)
        self._metadata.pop(key, None)
        if isinstance(value, Image):
            self._images[key] = value
        else:
            self._metadata[key] = value

    def __contains__(self, name: object) -> bool:
        return name in self._images

    def __iter__(self) -> Iterator[str]:
        yield from self._images

    def __len__(self) -> int:
        return len(self._images)

    def keys(self):
        return list(self._images)

    def get(self, key: str, default: Any = None) -> Any:
        return self._images.get(key, default)

    def items(self):
        return list(self._images.items())

    def values(self):
        return list(self._images.values())

    # --- Properties ---

    @property
    def metadata(self) -> dict[str, Any]:
        return self._metadata

    @property
    def images(self) -> dict[str, Image]:
        return self._images

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

    # --- Behavior ---

    def to(self, device: Any = None, dtype: Any = None) -> "Subject":
        for image in self._images.values():
            image.to(device, dtype)
        return self

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
        new._metadata = _copy.deepcopy(self._metadata, memo)
        new.applied_transforms = list(self.applied_transforms)
        return new

    def __repr__(self) -> str:
        parts = []
        if self._images:
            parts.append(f"images: {tuple(self._images)}")
        if self._metadata:
            parts.append(f"metadata: {tuple(self._metadata)}")
        return f"Subject({'; '.join(parts)})"
