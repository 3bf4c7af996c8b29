"""What the reference knows of a cell: the images of its configuration,
the batch size, the device it computes on, and its precision."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Context:
    #: name -> ImageSpec, in the configuration's order
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
