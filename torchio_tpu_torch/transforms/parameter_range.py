"""Randomization DSL: scalars, ranges, choices, and distributions.

Counterpart of ``torchio_tpu/transforms/parameter_range.py``, copied
verbatim: the same ``seed()`` draws bit-identical parameters in both
packages. Every random transform argument accepts::

    scalar              -> deterministic, broadcast to 3 axes
    (lo, hi)            -> U(lo, hi), same range each axis
    (a, b, c)           -> deterministic per-axis (all plain numbers)
    (l0, h0, l1, h1, l2, h2) -> per-axis ranges
    Choice([...])       -> discrete draw
    distribution        -> any object with .sample() / .rvs()
    3-tuple of mixed specs, e.g. (0, Choice([-90, 0, 90]), (-10, 10))

Sampling happens on host (numpy) so parameters are concrete and
JSON-serializable for history replay.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from .. import random as tio_random


class Choice:
    """A discrete set of values with optional probabilities."""

    def __init__(
        self,
        values: Sequence[float],
        probabilities: Sequence[float] | None = None,
    ) -> None:
        if len(values) < 1:
            raise ValueError("Choice requires at least one value")
        self._values = np.asarray([float(v) for v in values])
        if probabilities is None:
            self._probs = np.full(len(values), 1.0 / len(values))
        else:
            if len(probabilities) != len(values):
                raise ValueError(
                    f"Expected {len(values)} probabilities, got {len(probabilities)}"
                )
            p = np.asarray([float(x) for x in probabilities])
            self._probs = p / p.sum()

    @property
    def values(self) -> np.ndarray:
        return self._values

    @property
    def probabilities(self) -> np.ndarray:
        return self._probs

    def sample(self) -> float:
        return float(tio_random.get_rng().choice(self._values, p=self._probs))

    def sample_batched(self, n: int) -> np.ndarray:
        return tio_random.get_rng().choice(self._values, size=n, p=self._probs)

    def __repr__(self) -> str:
        vals = ", ".join(
            f"{v:.1f}" if v == int(v) else f"{v}" for v in self._values.tolist()
        )
        if np.allclose(self._probs, self._probs[0]):
            return f"Choice([{vals}])"
        probs = ", ".join(f"{p:.2f}" for p in self._probs.tolist())
        return f"Choice([{vals}], p=[{probs}])"


def _is_distribution(obj: Any) -> bool:
    """Duck-typed distribution: torch.distributions or scipy frozen dists."""
    return (
        not isinstance(obj, (Choice, int, float, tuple, list))
        and (hasattr(obj, "sample") or hasattr(obj, "rvs"))
    )


def _draw_dist(dist: Any, n: int | None = None):
    if hasattr(dist, "rvs"):
        out = dist.rvs(size=n if n else 1)
        arr = np.asarray(out, dtype=np.float64).reshape(-1)
    else:  # torch-style .sample()
        out = dist.sample() if n is None else dist.sample((n,))
        arr = np.asarray(out, dtype=np.float64).reshape(-1)
    return float(arr[0]) if n is None else arr[:n].astype(np.float64)


AxisSpec = Any  # float | (lo, hi) | Choice | distribution


def _sample_axis(spec: AxisSpec) -> float:
    if isinstance(spec, (int, float)):
        return float(spec)
    if isinstance(spec, Choice):
        return spec.sample()
    if isinstance(spec, tuple):
        lo, hi = spec
        return float(lo) if lo == hi else float(tio_random.uniform(lo, hi))
    return _draw_dist(spec)


def _sample_axis_batched(spec: AxisSpec, n: int) -> np.ndarray:
    if isinstance(spec, (int, float)):
        return np.full(n, float(spec))
    if isinstance(spec, Choice):
        return spec.sample_batched(n)
    if isinstance(spec, tuple):
        lo, hi = spec
        if lo == hi:
            return np.full(n, float(lo))
        return tio_random.uniform(float(lo), float(hi), n)
    return _draw_dist(spec, n)


def _parse_single(spec: Any) -> AxisSpec:
    if isinstance(spec, (int, float)):
        return float(spec)
    if isinstance(spec, Choice) or _is_distribution(spec):
        return spec
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        lo, hi = spec
        if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
            return (float(lo), float(hi))
    raise TypeError(
        "Per-axis spec must be a number, (lo, hi) pair, Choice, or"
        f" distribution, got {type(spec).__name__}"
    )


def _parse_tuple(value: tuple) -> tuple[AxisSpec, AxisSpec, AxisSpec]:
    n = len(value)
    plain = all(isinstance(v, (int, float)) for v in value)
    if n == 3:
        if plain:
            return (float(value[0]), float(value[1]), float(value[2]))
        return tuple(_parse_single(v) for v in value)  # type: ignore[return-value]
    if not plain:
        raise ValueError(f"Mixed per-axis specs require exactly 3 elements, got {n}")
    if n == 1:
        v = float(value[0])
        return (v, v, v)
    if n == 2:
        r = (float(value[0]), float(value[1]))
        return (r, r, r)
    if n == 6:
        vals = [float(v) for v in value]
        return ((vals[0], vals[1]), (vals[2], vals[3]), (vals[4], vals[5]))
    raise ValueError(f"Tuple must have 1, 2, 3, or 6 elements, got {n}")


class _ParameterRange:
    """Parsed per-axis parameter specification; see module docstring."""

    def __init__(self, value: Any) -> None:
        self._original = value
        if isinstance(value, (int, float)):
            v = float(value)
            self._axes: tuple[AxisSpec, AxisSpec, AxisSpec] = (v, v, v)
        elif isinstance(value, Choice) or _is_distribution(value):
            self._axes = (value, value, value)
        elif isinstance(value, (tuple, list)):
            self._axes = _parse_tuple(tuple(value))
        else:
            raise TypeError(
                "Expected number, tuple, Choice, or distribution,"
                f" got {type(value).__name__}"
            )

    @property
    def is_deterministic(self) -> bool:
        return all(isinstance(a, (int, float)) for a in self._axes)

    def is_constant(self, value: float) -> bool:
        for axis in self._axes:
            if isinstance(axis, (int, float)):
                if float(axis) != float(value):
                    return False
            elif isinstance(axis, tuple):
                lo, hi = axis
                if not (lo == hi == value):
                    return False
            else:
                return False
        return True

    @property
    def _ranges(self):
        out = []
        for a in self._axes:
            if isinstance(a, (int, float)):
                out.append((float(a), float(a)))
            elif isinstance(a, tuple):
                out.append(a)
            else:
                out.append((0.0, 0.0))
        return (out[0], out[1], out[2])

    def sample(self, n: int | None = None):
        """One 3-tuple of floats, or an (n, 3) float64 array."""
        if n is None:
            return tuple(_sample_axis(a) for a in self._axes)
        cols = [_sample_axis_batched(a, n) for a in self._axes]
        return np.stack(cols, axis=-1)

    def sample_1d(self, n: int | None = None):
        """One float (first axis spec), or an (n,) array."""
        if n is None:
            return _sample_axis(self._axes[0])
        return _sample_axis_batched(self._axes[0], n)

    def __repr__(self) -> str:
        v = self._original
        if isinstance(v, Choice) or _is_distribution(v):
            return repr(v)
        if isinstance(v, tuple):
            return f"({', '.join(repr(x) for x in v)})"
        return str(v)


def to_range(value: Any) -> _ParameterRange:
    return _ParameterRange(value)


def to_nonneg_range(value: Any) -> _ParameterRange:
    pr = _ParameterRange(value)
    for a in pr._axes:
        if isinstance(a, tuple) or isinstance(a, (int, float)):
            pass
        else:
            return pr  # distributions are unchecked
    for lo, hi in pr._ranges:
        if lo < 0 or hi < 0:
            raise ValueError(f"Value must be non-negative, got {value}")
    return pr
