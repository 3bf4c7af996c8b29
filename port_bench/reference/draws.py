"""The host draws of a transform's parameters, replayed on a numpy
Generator in the order the program draws them: a transform's p-gate
coin, its per-element keep mask, and its parameter ranges (a number, a
``[lo, hi]`` range for every axis, three numbers, or three ``lo, hi``
pairs). Written from the behaviour of the public API; nothing of the
program is imported."""

from __future__ import annotations

import numpy as np

#: the exclusive top of a device draw's recorded seed (31 bits)
SEED_TOP = 2**31 - 1


def axes(value) -> tuple:
    """Three per-axis specs: a float, or a ``(lo, hi)`` pair."""
    if isinstance(value, (int, float)):
        return (float(value),) * 3
    values = [float(v) for v in value]
    if len(values) == 1:
        return (values[0],) * 3
    if len(values) == 2:
        return ((values[0], values[1]),) * 3
    if len(values) == 3:
        return tuple(values)
    if len(values) == 6:
        return tuple((values[2 * a], values[2 * a + 1]) for a in range(3))
    raise ValueError(f"a range has 1, 2, 3 or 6 numbers, got {value!r}")


def _axis(spec, rng: np.random.Generator) -> float:
    if isinstance(spec, float):
        return spec
    lo, hi = spec
    return float(lo) if lo == hi else float(rng.uniform(lo, hi))


def sample(value, rng: np.random.Generator) -> tuple[float, float, float]:
    """One value an axis, each axis drawn in turn."""
    return tuple(_axis(spec, rng) for spec in axes(value))


def sample_1d(value, rng: np.random.Generator, n: int | None = None):
    """The first axis's spec: one value, or ``n`` of them in one draw."""
    spec = axes(value)[0]
    if n is None:
        return _axis(spec, rng)
    if isinstance(spec, float):
        return np.full(n, spec)
    lo, hi = spec
    return np.full(n, float(lo)) if lo == hi else rng.uniform(float(lo), float(hi), n)


def per_instance(args: dict, batch: int) -> bool:
    """Whether the transform draws its parameters once an element."""
    return bool(args.get("per_instance", True)) and batch > 1


def gated_per_element(args: dict, batch: int) -> bool:
    p = float(args.get("p", 1.0))
    return per_instance(args, batch) and 0.0 < p < 1.0


def coin(args: dict, rng: np.random.Generator, batch: int, per_element_p: bool = True) -> bool:
    """The transform's p-gate: a batch-wide coin unless each element is
    gated on its own (then no coin is drawn). True where it applies."""
    p = float(args.get("p", 1.0))
    if per_element_p and gated_per_element(args, batch):
        return True
    return float(rng.random()) < p


def keep_mask(args: dict, rng: np.random.Generator, batch: int) -> np.ndarray | None:
    """The per-element gate: one draw of ``batch`` uniforms, or None."""
    if not gated_per_element(args, batch):
        return None
    return rng.random(batch) < float(args.get("p", 1.0))


def seed(rng: np.random.Generator) -> int:
    return int(rng.integers(0, SEED_TOP))


def kept(keep, b: int) -> bool:
    return keep is None or bool(keep[b])
