"""MONAI and Cornucopia transform adapters (optional dependencies).

Counterpart of ``torchio_tpu/transforms/monai_adapter.py``: wraps MONAI
dict-style ``MapTransform`` or array transforms (Image <->
``monai.data.MetaTensor`` with the affine carried both ways) and
Cornucopia transforms; no history, because the wrapped transform is
opaque. Both libraries run on torch tensors, so the adapters hand over
each image's own tensor on its device (a view of the batch's tensor) and
take back the tensors they return, with no copy to the host; only a
MetaTensor's 4x4 affine is read back on the host.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..data.batch import SubjectsBatch
from ..data.image import ScalarImage
from .transform import Transform


def _filter_images(images: dict, include, exclude) -> dict:
    """Apply include/exclude name filters (reference
    cornucopia_adapter.py:137-144, monai_adapter.py:101-109)."""
    if include is not None:
        images = {k: v for k, v in images.items() if k in include}
    if exclude is not None:
        images = {k: v for k, v in images.items() if k not in exclude}
    return images


def _plain(value: Any) -> Any:
    """A returned tensor as a plain, detached ``torch.Tensor`` on its
    device (a MetaTensor's data without its metadata); anything else (a
    numpy array) as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().as_subclass(torch.Tensor)
    return value


def _host_matrix(matrix: Any) -> np.ndarray:
    """A 4x4 affine as host float64 numpy."""
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu()
    return np.asarray(matrix, dtype=np.float64)


def _require_monai():
    try:
        import monai  # noqa: F401

        return monai
    except ImportError as e:  # pragma: no cover - optional dep
        raise ImportError(
            "MonaiAdapter requires MONAI: pip install monai"
        ) from e


class MonaiAdapter(Transform):
    """Run a MONAI transform inside a torchio_tpu_torch pipeline.

    Dict-style (``MapTransform``) instances receive ``{name: MetaTensor}``;
    array transforms receive each image tensor individually. The wrapped
    transform is opaque, so no history entry is recorded.
    """

    _records_history = False

    def __init__(self, monai_transform: Any, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not callable(monai_transform):
            raise TypeError(
                "monai_transform must be callable,"
                f" got {type(monai_transform).__name__}"
            )
        self.transform = monai_transform

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        _require_monai()
        from monai.data import MetaTensor
        from monai.transforms import MapTransform

        is_dict_style = isinstance(self.transform, MapTransform)
        subjects = batch.unbatch()
        for subject in subjects:
            if is_dict_style:
                # Dict-style (MapTransform): ALL images (the transform's
                # `keys` decide what it touches — filtering here would
                # break image/label-coupled spatial transforms) plus
                # metadata, mirroring the reference's
                # _apply_dict_transform (monai_adapter.py:167-186).
                if not subject.images:
                    continue
                data: dict[str, Any] = {}
                for name, image in subject.images.items():
                    data[name] = MetaTensor(image.data, affine=torch.as_tensor(image.affine.data))
                data.update(subject.metadata)
                result = self.transform(data)
                for name, image in subject.images.items():
                    value = result.get(name)
                    if not isinstance(value, torch.Tensor):
                        continue
                    image.set_data(_plain(value))
                    if isinstance(value, MetaTensor) and value.affine is not None:
                        image.affine = _host_matrix(value.affine)
            else:
                # Array-style: ScalarImage only, then include/exclude
                # (reference monai_adapter.py:101-109).
                scalars = {
                    k: v
                    for k, v in subject.images.items()
                    if isinstance(v, ScalarImage)
                }
                images = _filter_images(scalars, self.include, self.exclude)
                for image in images.values():
                    image.set_data(_plain(self.transform(image.data)))
        rebuilt = SubjectsBatch.from_subjects(subjects)
        batch._images = rebuilt._images
        batch._metadata = rebuilt._metadata
        return batch


class CornucopiaAdapter(Transform):
    """Run a Cornucopia transform on all image tensors positionally.

    Scalar images first, then labels, so Cornucopia shares spatial
    parameters across them; not invertible.
    """

    _records_history = False

    def __init__(self, cornucopia_transform: Any, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not callable(cornucopia_transform):
            raise TypeError(
                "cornucopia_transform must be callable,"
                f" got {type(cornucopia_transform).__name__}"
            )
        self.transform = cornucopia_transform

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        subjects = batch.unbatch()
        for subject in subjects:
            images = _filter_images(
                dict(subject.images), self.include, self.exclude
            )
            scalars = [
                (n, img)
                for n, img in images.items()
                if isinstance(img, ScalarImage)
            ]
            labels = [
                (n, img)
                for n, img in images.items()
                if not isinstance(img, ScalarImage)
            ]
            ordered = scalars + labels
            if not ordered:
                continue  # filter matched nothing (reference :116-117)
            results = self.transform(*(img.data for _, img in ordered))
            if not isinstance(results, (tuple, list)):
                results = (results,)
            if len(results) != len(ordered):
                raise ValueError(
                    f"Cornucopia transform returned {len(results)} tensors"
                    f" for {len(ordered)} input images"
                )
            for (_, img), result in zip(ordered, results):
                img.set_data(_plain(result))
        rebuilt = SubjectsBatch.from_subjects(subjects)
        batch._images = rebuilt._images
        batch._metadata = rebuilt._metadata
        return batch
