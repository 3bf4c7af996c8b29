"""Patch location record for the patch pipeline.

Counterpart of ``torchio_tpu/data/patch.py`` (a copy: the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PatchLocation:
    """Corner index + size of a patch within a volume.

    Attributes:
        index: (i, j, k) corner of the patch (voxel indices).
        size: (si, sj, sk) patch extent.
        subject_index: position of the source subject in a batch, if any.
    """

    index: tuple[int, int, int]
    size: tuple[int, int, int]
    subject_index: int | None = None

    @property
    def index_ini(self) -> tuple[int, int, int]:
        """Alias for the corner index."""
        return self.index

    @property
    def index_fin(self) -> tuple[int, int, int]:
        """Exclusive end index per axis."""
        return tuple(i + s for i, s in zip(self.index, self.size))  # type: ignore[return-value]

    def to_slices(self) -> tuple[slice, slice, slice]:
        """Spatial slices selecting the patch."""
        return tuple(  # type: ignore[return-value]
            slice(i, i + s) for i, s in zip(self.index, self.size)
        )

    def scaled(self, factors: tuple[float, float, float]) -> "PatchLocation":
        """Location rescaled for down/up-sampled model outputs."""
        index = tuple(int(round(i * f)) for i, f in zip(self.index, factors))
        size = tuple(int(round(s * f)) for s, f in zip(self.size, factors))
        return PatchLocation(index, size, self.subject_index)  # type: ignore[arg-type]

    def to_json(self) -> dict:
        return {
            "index": list(self.index),
            "size": list(self.size),
            "subject_index": self.subject_index,
        }

    @classmethod
    def from_json(cls, d: dict) -> "PatchLocation":
        return cls(tuple(d["index"]), tuple(d["size"]), d.get("subject_index"))
