"""The plain reference of a traffic mix: the host draws of every call of
a window replayed from the window's seed, and one element of a call
computed transform by transform from the cell's inputs.

It imports nothing of the program and takes nothing the program made:
the draws come from the seed, the inputs from the configuration (see
``port_bench/inputs.py``)."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.context import Context
from port_bench.registry import reference_transform


class Reference:
    def __init__(self, traffic: dict, ctx: Context):
        self.steps = [(name, args, reference_transform(name)) for name, args in traffic["transforms"]]
        self.ctx = ctx

    def replay(self, window_seed: int, calls: int) -> list[list]:
        """Each of the first ``calls`` calls' parameters, one entry a
        transform (None where its coin skipped it)."""
        rng = np.random.default_rng(window_seed)
        return [
            [module.draw(args, rng, self.ctx) for _, args, module in self.steps]
            for _ in range(calls)
        ]

    def element(self, drawn: list, inputs: dict, e: int) -> dict:
        """Element ``e`` of a call with parameters ``drawn`` from the
        batch's ``inputs`` (name -> (B, C, I, J, K) on the reference's
        device): name -> (C, I, J, K), every image present at the end.
        Each step sees only the images present before it; a made image
        appears at the step that writes it."""
        needs_first = any(module.NEEDS_FIRST for _, _, module in self.steps)
        rows = sorted({0, e}) if needs_first else [e]
        index = torch.as_tensor(rows, device=self.ctx.device)
        data = {}
        for name, image in self.ctx.images.items():
            if image.made_by is None:
                x = inputs[name].index_select(0, index)
                data[name] = self.ctx.store(x) if image.kind == "scalar" else x
        for params, (_, args, module) in zip(drawn, self.steps):
            if params is not None:
                data = module.apply(params, args, data, rows, self.ctx.at(data))
        return {name: data[name][rows.index(e)] for name in data}
