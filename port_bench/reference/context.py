"""What the reference knows of a cell: the images of its configuration,
the batch size, the device it computes on, and its precision. A step of
the pipeline sees the images present at that step (:meth:`Context.at`);
the draws see the whole configuration."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class Context:
    #: name -> ImageSpec, in the configuration's order (at a step: the
    #: images present then, in the order of the step's data)
    images: dict
    batch: int
    device: torch.device
    #: the control: every stored intensity rounded to bfloat16
    low: bool = False

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An intensity volume as the reference keeps it between steps."""
        if self.low and x.dtype.is_floating_point:
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def scalars(self) -> list[str]:
        return [name for name, image in self.images.items() if image.kind == "scalar"]

    def at(self, data: dict) -> "Context":
        """This context restricted to the images present in ``data``, in
        ``data``'s order: an image made by a later step is not there yet."""
        unknown = [name for name in data if name not in self.images]
        if unknown:
            raise KeyError(f"images {unknown} are not in the configuration")
        return replace(self, images={name: self.images[name] for name in data})
