"""LabelsToImage: synthesise an intensity image from a label map
(SynthSeg's generative block).

Counterpart of ``torchio_tpu/transforms/intensity/labels_to_image.py``:
each label's tissue is Gaussian with a mean and a standard deviation
drawn on the host (per element where per-instance params are active),
written into a new ScalarImage. The Gaussian fields are ``jax.random``'s
own draws from the recorded seed: for each label in sorted order, ``key,
sub = split(key)`` and a ``normal(sub, (B, 1, I, J, K))``, one launch of
the threefry kernel on a card. A label whose means and standard
deviations are all zero draws nothing and does not split the key. One
label is drawn at a time, so that only one label's field is held at
once.

A sharded batch stays on each rank's region: the label set is counted
on the blocks and reduced (:func:`.._utils.region_labels`: two
``all_reduce`` over each split axis), each label's field is drawn at the
region only (:func:`torchio_tpu_torch.random.region_normals`, one
strided segment), and the new image is placed as the label map is.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ... import random as tio_random
from ...data.batch import ImagesBatch, SubjectsBatch
from ...data.image import LabelMap, ScalarImage
from ...parallel.mesh import Region, region_of
from .._utils import unique_labels
from ..parameter_range import to_range
from ..transform import Transform


def _per_element(values: list[dict], label: int) -> list[float]:
    """Each element's value for ``label``; a JSON-replayed history has
    string keys."""
    return [float(m.get(label, m.get(str(label), 0.0))) for m in values]


class LabelsToImage(Transform):
    """Generate Gaussian tissue per label and sum into a synthetic image.

    A sharded batch stays on each rank's region.

    Args:
        label_key: name of the LabelMap to use (first LabelMap if None).
        image_key: name for the generated ScalarImage.
        mean / std: optional per-label ranges (indexed by sorted label
            order); fall back to ``default_mean`` / ``default_std``.
        ignore_background: leave label 0 at zero intensity.
    """

    takes_sharded = True

    def __init__(
        self,
        label_key: str | None = None,
        *,
        image_key: str = "image_from_labels",
        mean: Sequence[Any] | None = None,
        std: Sequence[Any] | None = None,
        default_mean: Any = (0.1, 0.9),
        default_std: Any = (0.01, 0.1),
        ignore_background: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.label_key = label_key
        self.image_key = image_key
        self.mean_ranges = [to_range(m) for m in mean] if mean is not None else None
        self.std_ranges = [to_range(s) for s in std] if std is not None else None
        self.default_mean = to_range(default_mean)
        self.default_std = to_range(default_std)
        self.ignore_background = ignore_background

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    def _find_label_batch(self, batch: SubjectsBatch) -> ImagesBatch:
        if self.label_key is not None:
            if self.label_key not in batch.images:
                raise KeyError(
                    f"Label key '{self.label_key}' not found."
                    f" Available: {list(batch.images)}"
                )
            return batch.images[self.label_key]
        for img_batch in batch.images.values():
            if issubclass(img_batch.image_class, LabelMap):
                return img_batch
        raise KeyError("No LabelMap found in the subject")

    def _sample_label_values(self, unique):
        means: dict[int, float] = {}
        stds: dict[int, float] = {}
        for idx, label in enumerate(unique):
            label = int(label)
            if self.ignore_background and label == 0:
                means[label] = 0.0
                stds[label] = 0.0
                continue
            if self.mean_ranges is not None and idx < len(self.mean_ranges):
                means[label] = self.mean_ranges[idx].sample_1d()
            else:
                means[label] = self.default_mean.sample_1d()
            if self.std_ranges is not None and idx < len(self.std_ranges):
                stds[label] = self.std_ranges[idx].sample_1d()
            else:
                stds[label] = abs(self.default_std.sample_1d())
        return means, stds

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        label_batch = self._find_label_batch(batch)
        unique = unique_labels(label_batch.data)
        seed = tio_random.draw_seed()
        n = self._resolve_n(batch)
        if n is None:
            means, stds = self._sample_label_values(unique)
            return {"means": means, "stds": stds, "seed": seed}
        means_list, stds_list = [], []
        for _ in range(n):
            means, stds = self._sample_label_values(unique)
            means_list.append(means)
            stds_list.append(stds)
        params = {"means": means_list, "stds": stds_list, "seed": seed}
        self._tag_batched(params, batch, n, None, ["means", "stds"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        label_batch = self._find_label_batch(batch)
        region = region_of(label_batch.data)
        b = int(region.shape[0])
        if self._is_per_instance_params(params):
            means_list, stds_list = params["means"], params["stds"]
        else:
            means_list, stds_list = [params["means"]] * b, [params["stds"]] * b
        labels = sorted({int(k) for means in means_list for k in means})
        key = tio_random.prng_key(params["seed"])
        data = region.local[:, 0:1]
        dev = data.device
        # the fields' region: the label map's block of a (B, 1, I, J, K) draw
        field = Region(data, (b, 1, *region.shape[2:]), region.starts, region.sharding)
        result = torch.zeros(data.shape, dtype=torch.float32, device=dev)
        for label in labels:
            means = _per_element(means_list, label)
            stds = _per_element(stds_list, label)
            if not any(means) and not any(stds):
                continue
            key, sub = tio_random.split(key)
            if field.whole:
                tissue = tio_random.normal(sub, field.shape, dev)
            else:
                tissue = tio_random.region_normals([sub], field).reshape(data.shape)
            tissue = tissue * _column(field.take(stds), dev) + _column(field.take(means), dev)
            # labels are disjoint: each voxel takes its own label's tissue
            # (the JAX package adds tissue * mask over the labels)
            result = torch.where(data == label, tissue, result)
        image = ImagesBatch(
            field.wrap(result), [a.clone() for a in label_batch.affines], image_class=ScalarImage
        )
        if label_batch.sharding is not None:
            # placed as the label map (by ``gathered`` where the stage ran
            # on the whole tensors)
            image._sharding = label_batch.sharding
        batch.images[self.image_key] = image
        return batch


def _column(values: list[float], device) -> torch.Tensor:
    """(B, 1, 1, 1, 1) float32 per-element values."""
    return torch.tensor(values, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1, 1)
