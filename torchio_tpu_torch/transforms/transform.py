"""Transform engine base class.

Counterpart of ``torchio_tpu/transforms/transform.py``: input
polymorphism (Subject, Image, numpy array, tensor, dict, ImagesBatch,
SubjectsBatch), p-gating, per-instance parameters and ``_keep`` masks,
JSON-serializable params, history recording and the class registry.

Execution contract:

- ``make_params(batch)`` runs on the host and returns concrete,
  JSON-serializable parameters (numpy/python values), drawn from the same
  host RNG stream as the JAX package.
- ``apply_transform(batch, params)`` runs on the batch's device with
  torch ops and the package's kernels.
"""

from __future__ import annotations

import copy as _copy
import inspect
import warnings
from typing import Any

import numpy as np
import torch

from .. import random as tio_random
from ..data.batch import ImagesBatch, SubjectsBatch
from ..data.image import Image, ScalarImage
from ..data.subject import Subject


class AppliedTransform:
    """History record of one transform application (JSON-serializable).

    ``params`` may initially hold :class:`DeferredParam` device
    statistics; they resolve (one host transfer, cached) on first access.
    """

    __slots__ = ("name", "_params", "include", "exclude")

    def __init__(
        self,
        name: str,
        params: dict[str, Any] | None = None,
        include: list[str] | None = None,
        exclude: list[str] | None = None,
    ) -> None:
        self.name = name
        self._params = {} if params is None else params
        self.include = include
        self.exclude = exclude

    @property
    def params(self) -> dict[str, Any]:
        if _has_deferred(self._params):
            self._params = resolve_deferred_params(self._params)
        return self._params

    @params.setter
    def params(self, value: dict[str, Any]) -> None:
        self._params = value

    def raw_params(self) -> dict[str, Any]:
        """The params dict WITHOUT resolving deferred statistics."""
        return self._params

    def replace_params(self, params: dict[str, Any]) -> "AppliedTransform":
        return AppliedTransform(
            name=self.name, params=params, include=self.include, exclude=self.exclude
        )

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, AppliedTransform):
            return NotImplemented
        return (
            self.name == other.name
            and self.params == other.params
            and self.include == other.include
            and self.exclude == other.exclude
        )

    def __repr__(self) -> str:
        return (
            f"AppliedTransform(name={self.name!r}, params={self._params!r},"
            f" include={self.include!r}, exclude={self.exclude!r})"
        )


class DeferredParam:
    """A history param computed on the device, recorded without a
    blocking host pull.

    Args:
        device: the tensor holding the statistic(s).
        convert: host-side ``np.ndarray -> JSON value`` finalizer;
            defaults to ``tolist``.
        eager: resolve at the end of ``forward`` instead of on first
            history access (for finalizers that validate).
    """

    __slots__ = ("device", "_convert", "_resolved", "eager")

    _UNRESOLVED = object()

    def __init__(self, device: Any, convert: Any = None, *, eager: bool = False) -> None:
        self.device = device
        self._convert = convert
        self._resolved: Any = DeferredParam._UNRESOLVED
        self.eager = eager

    def resolve(self) -> Any:
        if self._resolved is DeferredParam._UNRESOLVED:
            host = np.asarray(self.device.detach().cpu())
            self._resolved = (
                self._convert(host) if self._convert is not None else host.tolist()
            )
        return self._resolved

    def __deepcopy__(self, memo: dict) -> "DeferredParam":
        return self


def resolve_deferred_params(value: Any) -> Any:
    """Replace every :class:`DeferredParam` in a params tree with its
    resolved JSON value."""
    if isinstance(value, DeferredParam):
        return value.resolve()
    if isinstance(value, dict):
        return {k: resolve_deferred_params(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(resolve_deferred_params(v) for v in value)
    return value


def _has_deferred(value: Any) -> bool:
    if isinstance(value, DeferredParam):
        return True
    if isinstance(value, dict):
        return any(_has_deferred(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_has_deferred(v) for v in value)
    return False


def _resolve_eager_deferred(value: Any) -> Any:
    """Resolve only the eager (validating) deferred params."""
    if isinstance(value, DeferredParam):
        return value.resolve() if value.eager else value
    if isinstance(value, dict):
        return {k: _resolve_eager_deferred(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_eager_deferred(v) for v in value)
    return value


#: Class-name -> class registry for history replay.
_TRANSFORM_REGISTRY: dict[str, type["Transform"]] = {}


def get_transform_class(name: str) -> type["Transform"]:
    return _TRANSFORM_REGISTRY[name]


def _all_elements_gated_out(params: dict[str, Any]) -> bool:
    keep = params.get("_keep")
    return keep is not None and not any(keep)


def record_history(batch: SubjectsBatch, transform: "Transform", params: dict) -> None:
    """Append ``transform``'s record to ``batch``'s history (unless every
    element was gated out)."""
    if _has_deferred(params):
        params = _resolve_eager_deferred(params)
    if not transform._records_history or _all_elements_gated_out(params):
        return
    batch.applied_transforms.append(
        AppliedTransform(
            name=type(transform).__name__,
            params=params,
            include=None if transform.include is None else list(transform.include),
            exclude=None if transform.exclude is None else list(transform.exclude),
        )
    )


class Transform:
    """Abstract base for all transforms.

    Call with a Subject, Image, numpy array, torch tensor, dict of 4D
    arrays, ImagesBatch, or SubjectsBatch; the output type matches the
    input type.

    Args:
        p: application probability. With per-instance gating active, each
            batch element is gated independently.
        copy: deep-copy the input before transforming.
        per_instance: sample independent parameters per batch element
            (when the transform supports it and batch_size > 1).
        include: only apply to these image names.
        exclude: never apply to these image names.
    """

    def __init__(
        self,
        *,
        p: float = 1.0,
        copy: bool = True,
        per_instance: bool = True,
        include: list[str] | None = None,
        exclude: list[str] | None = None,
    ) -> None:
        if not 0 <= p <= 1:
            raise ValueError(f"Probability must be in [0, 1], got {p}")
        self.p = p
        self.copy = copy
        self.per_instance = per_instance
        self.include = list(include) if include is not None else None
        self.exclude = list(exclude) if exclude is not None else None

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        _TRANSFORM_REGISTRY[cls.__name__] = cls

    # --- Application ---

    def __call__(self, data: Any) -> Any:
        return self.forward(data)

    def forward(self, data: Any) -> Any:
        if self.copy:
            data = _copy.deepcopy(data)
        batch, unwrap = self._wrap(data)
        if (
            not self._per_instance_p_active(batch)
            and float(tio_random.random()) >= self.p
        ):
            return unwrap(batch)
        params = self.make_params(batch)
        batch = self.apply_transform(batch, params)
        record_history(batch, self, params)
        result = unwrap(batch)
        if isinstance(result, (Subject, Image, ImagesBatch)):
            result.applied_transforms = list(batch.applied_transforms)
        return result

    #: False in transforms that delegate to children which record their
    #: own (invertible) history entries (CropOrPad -> Pad + Crop).
    _records_history = True

    # --- Per-instance machinery ---

    @property
    def supports_per_instance_params(self) -> bool:
        """Override to True in transforms that sample per-element params."""
        return False

    @property
    def supports_per_instance_p(self) -> bool:
        """Override to True in shape-preserving transforms that can gate
        each element independently."""
        return False

    def _per_instance_active(self, batch: SubjectsBatch) -> bool:
        return (
            self.per_instance
            and self.supports_per_instance_params
            and batch.batch_size > 1
        )

    def _per_instance_p_active(self, batch: SubjectsBatch) -> bool:
        return (
            self.per_instance
            and self.supports_per_instance_p
            and batch.batch_size > 1
            and 0.0 < self.p < 1.0
        )

    def _resolve_n(self, batch: SubjectsBatch) -> int | None:
        """Batch size when per-instance sampling is active, else None."""
        return batch.batch_size if self._per_instance_active(batch) else None

    def _keep_mask(self, batch: SubjectsBatch, n: int | None) -> np.ndarray | None:
        """(n,) boolean mask of elements that receive the transform."""
        if n is None or not self._per_instance_p_active(batch):
            return None
        return tio_random.random(n) < self.p

    @staticmethod
    def _mask_identity(value: Any, keep: np.ndarray | None, *, identity: float):
        """Gated-out elements get the identity parameter value."""
        if keep is None or not isinstance(value, np.ndarray):
            return value
        return np.where(
            keep.reshape((-1,) + (1,) * (value.ndim - 1)),
            value,
            np.full_like(value, identity),
        )

    @staticmethod
    def _serialize_param(value: Any) -> Any:
        """Convert arrays to JSON-serializable nested lists."""
        if isinstance(value, np.ndarray):
            return value.tolist()
        if isinstance(value, (np.floating, np.integer, np.bool_)):
            return value.item()
        return value

    @staticmethod
    def _is_per_instance_params(params: dict[str, Any]) -> bool:
        return "_batched_keys" in params

    def _tag_batched(
        self,
        params: dict[str, Any],
        batch: SubjectsBatch,
        n: int | None,
        keep: np.ndarray | None,
        batched_keys: list[str],
    ) -> None:
        """Annotate per-instance params for history slicing at unbatch."""
        if n is None:
            return
        params["_batch_size"] = batch.batch_size
        params["_batched_keys"] = list(batched_keys)
        if keep is not None:
            params["_keep"] = [bool(k) for k in keep]

    # --- Hooks ---

    def fused_stage(self, batch: SubjectsBatch):
        """Contribution to a fused elementwise chain, or None.

        Must not consume RNG before deciding eligibility: ``Compose(
        fuse=True)`` checks :meth:`fusable`, draws the p-gate coin, then
        builds the stage -- the RNG order of :meth:`forward`.
        """
        return None

    def fusable(self, batch: SubjectsBatch) -> bool:
        """Whether :meth:`fused_stage` would return a stage (no RNG)."""
        return False

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        """Sample random parameters (host-side, concrete, JSON-able)."""
        return {}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        """Apply with given params. Data is 5D (B, C, I, J, K)."""
        raise NotImplementedError

    @property
    def invertible(self) -> bool:
        return False

    def inverse(self, params: dict[str, Any]) -> "Transform":
        raise NotImplementedError(f"{type(self).__name__} is not invertible")

    # --- Scoping ---

    def _get_images(self, batch: SubjectsBatch) -> dict[str, ImagesBatch]:
        images = batch.images
        if self.include is not None:
            images = {k: v for k, v in images.items() if k in self.include}
        if self.exclude is not None:
            images = {k: v for k, v in images.items() if k not in self.exclude}
        return images

    # --- UX ---

    def warn_if_noop(self, *, is_noop: bool, hint: str) -> None:
        """Warn when default arguments make the transform a no-op."""
        if is_noop:
            warnings.warn(
                f"{type(self).__name__} with default arguments is a no-op;"
                f" consider e.g. {hint}",
                RuntimeWarning,
                stacklevel=3,
            )

    def __repr__(self) -> str:
        from .parameter_range import _ParameterRange

        cls = type(self)
        parts = []
        for name, default in _collect_init_params(cls).items():
            value = getattr(self, name, default)
            if isinstance(value, _ParameterRange):
                if value._original == default:
                    continue
                parts.append(f"{name}={value!r}")
            elif not _values_equal(value, default):
                parts.append(f"{name}={value!r}")
        return f"{cls.__name__}({', '.join(parts)})"

    def __add__(self, other: "Transform"):
        """``t1 + t2 -> Compose([t1, t2])``, flattening Compose operands."""
        from .compose import Compose

        if not isinstance(other, Transform):
            return NotImplemented
        left = self.transforms if isinstance(self, Compose) else [self]
        right = other.transforms if isinstance(other, Compose) else [other]
        return Compose([*left, *right])

    # --- Wrapping ---

    @staticmethod
    def _wrap(data: Any) -> tuple[SubjectsBatch, Any]:
        """Convert any accepted input into a SubjectsBatch + unwrap fn."""
        if isinstance(data, SubjectsBatch):
            return data, lambda b: b
        if isinstance(data, ImagesBatch):
            sb = SubjectsBatch({"tio_default_image": data})
            return sb, lambda b: b.images["tio_default_image"]
        if isinstance(data, Subject):
            return SubjectsBatch.from_subjects([data]), _unwrap_subject
        if isinstance(data, Image):
            return _wrap_single_image(data, _unwrap_image)
        if isinstance(data, np.ndarray):
            arr = data if data.ndim == 4 else data[None]
            if arr.ndim != 4:
                raise ValueError(f"Array input must be 3D or 4D, got {data.ndim}D")
            return _wrap_single_image(
                ScalarImage(arr.astype(np.float32, copy=False)), _unwrap_ndarray
            )
        if isinstance(data, torch.Tensor):
            arr = data if data.ndim == 4 else data[None]
            if arr.ndim != 4:
                raise ValueError(f"Tensor input must be 3D or 4D, got {data.ndim}D")
            return _wrap_single_image(ScalarImage(arr), _unwrap_tensor)
        if isinstance(data, dict):
            return _wrap_dict(data)
        raise TypeError(
            "Expected Subject, Image, array, tensor, dict, ImagesBatch, or"
            f" SubjectsBatch, got {type(data).__name__}"
        )


def _wrap_single_image(img: Image, unwrap_fn: Any) -> tuple[SubjectsBatch, Any]:
    return SubjectsBatch.from_subjects([Subject(tio_default_image=img)]), unwrap_fn


def _unwrap_subject(batch: SubjectsBatch) -> Subject:
    return batch.unbatch()[0]


def _unwrap_image(batch: SubjectsBatch) -> Image:
    return batch.unbatch()[0].tio_default_image


def _unwrap_ndarray(batch: SubjectsBatch) -> np.ndarray:
    return batch.unbatch()[0].tio_default_image.numpy()


def _unwrap_tensor(batch: SubjectsBatch) -> torch.Tensor:
    return batch.unbatch()[0].tio_default_image.data


def _wrap_dict(data: dict) -> tuple[SubjectsBatch, Any]:
    kwargs: dict[str, Any] = {}
    for k, v in data.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            kwargs[k] = ScalarImage(v)
        else:
            kwargs[k] = v
    keys = [str(k) for k in data]
    sb = SubjectsBatch.from_subjects([Subject(**kwargs)])
    return sb, lambda b: _unwrap_dict(b, keys)


def _unwrap_dict(batch: SubjectsBatch, keys: list[str]) -> dict[str, Any]:
    sub = batch.unbatch()[0]
    out: dict[str, Any] = {}
    for k in keys:
        entry = sub.get(k, sub.metadata.get(k))
        out[k] = entry.data if isinstance(entry, Image) else entry
    return out


def _collect_init_params(cls: type) -> dict[str, Any]:
    """{name: default} for all __init__ params up the MRO."""
    params: dict[str, Any] = {}
    for klass in cls.__mro__:
        if klass is object:
            break
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        for name, param in inspect.signature(init).parameters.items():
            if name == "self" or param.kind in (
                inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD,
            ):
                continue
            params.setdefault(name, param.default)
    return params


def _values_equal(a: Any, b: Any) -> bool:
    try:
        result = a == b
    except Exception:
        return False
    if isinstance(result, np.ndarray):
        return bool(np.all(result))
    return bool(result)


class SpatialTransform(Transform):
    """Modifies geometry: applies to all images."""


class IntensityTransform(Transform):
    """Modifies voxel values: applies to ScalarImage batches only."""

    def _get_images(self, batch: SubjectsBatch) -> dict[str, ImagesBatch]:
        images = {
            k: v
            for k, v in batch.images.items()
            if issubclass(v.image_class, ScalarImage)
        }
        if self.include is not None:
            images = {k: v for k, v in images.items() if k in self.include}
        if self.exclude is not None:
            images = {k: v for k, v in images.items() if k not in self.exclude}
        return images
