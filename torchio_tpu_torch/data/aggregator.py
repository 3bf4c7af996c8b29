"""PatchAggregator: reassemble dense-inference patches into a volume.

Counterpart of ``torchio_tpu/data/aggregator.py``: overlap modes
``crop``, ``average`` and ``hann`` (a separable 3-D Hann window, the
result normalized by the true window sum), a dict of outputs, and
``output_shape`` scaling for heads that resample. The buffers are float32
tensors on the device of the first batch added (host data goes to the
package's default device), so patches coming off a model never leave it;
``get_output()`` is the one copy to the host, and ``device=True`` skips it.

The JAX package runs its flush as a ``lax.scan`` of slice-adds in one
XLA program (no Pallas); the port adds the patches in the same order, one
after the other: ``out[:, region] += patch * window`` and
``cnt[:, region] += window``. ``average`` and ``hann`` batches wait in a
list and are added at ``get_output`` or once they hold ``flush_bytes``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import as_tensor
from .patch import PatchLocation


def _hann_1d(size: int) -> np.ndarray:
    """torch.hann_window(size + 2, periodic=False)[1:-1], computed in
    float64 and rounded to float32 (as the JAX package)."""
    n = np.arange(1, size + 1, dtype=np.float64)
    return (0.5 * (1 - np.cos(2 * np.pi * n / (size + 1)))).astype(np.float32)


def _build_hann_3d(patch_size) -> np.ndarray:
    window = np.ones((1, 1, 1), np.float32)
    for dim, size in enumerate(patch_size):
        shape = [1, 1, 1]
        shape[dim] = size
        window = window * _hann_1d(size).reshape(shape)
    return window


def _region(corner, size, spatial_shape) -> tuple[slice, ...]:
    """The (C, I, J, K) slices of a ``size`` block at ``corner``, the
    corner clamped so the block fits, as XLA's ``dynamic_slice`` and
    ``dynamic_update_slice`` clamp it in the JAX package."""
    starts = (
        min(max(int(c), 0), int(n) - int(s)) for c, s, n in zip(corner, size, spatial_shape)
    )
    return (slice(None),) + tuple(slice(c, c + int(s)) for c, s in zip(starts, size))


def _torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype, or the torch dtype of a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class PatchAggregator:
    """Add patches into (C, I, J, K) output volumes.

    Args:
        spatial_shape: input-volume spatial shape the locations refer to.
        overlap_mode: ``"crop"`` (trim overlap/2 at non-boundary faces),
            ``"average"`` (sum + count), or ``"hann"`` (separable 3D
            Hann-window weighting — smoothest seams).
        patch_overlap: overlap used during sampling (for ``crop``).
        output_shape: volume shape when the model output is spatially
            scaled vs the input patches (locations are rescaled).
        flush_bytes: pending ``average``/``hann`` bytes that trigger a
            flush.
    """

    def __init__(
        self,
        spatial_shape,
        overlap_mode: str = "crop",
        patch_overlap=0,
        output_shape=None,
        flush_bytes: int = 256 * 1024**2,
    ) -> None:
        if overlap_mode not in ("crop", "average", "hann"):
            raise ValueError(
                f"overlap_mode must be 'crop', 'average', or 'hann',"
                f" got {overlap_mode!r}"
            )
        self.input_spatial_shape = tuple(int(s) for s in spatial_shape)
        self.overlap_mode = overlap_mode
        if isinstance(patch_overlap, (int, np.integer)):
            patch_overlap = (int(patch_overlap),) * 3
        self.patch_overlap = tuple(int(v) for v in patch_overlap)
        if output_shape is not None:
            self.spatial_shape = tuple(int(s) for s in output_shape)
            self._scale = tuple(
                o / i for o, i in zip(self.spatial_shape, self.input_spatial_shape)
            )
        else:
            self.spatial_shape = self.input_spatial_shape
            self._scale = (1.0, 1.0, 1.0)
        self._outputs: dict[str, torch.Tensor] = {}
        self._counts: dict[str, torch.Tensor] = {}
        self._hann_cache: dict[tuple, torch.Tensor] = {}
        self._flush_bytes = int(flush_bytes)
        self._pending: dict[str, list[tuple[torch.Tensor, Any, np.ndarray]]] = {}
        self._pending_bytes: dict[str, int] = {}

    def add_batch(self, batch: Any, locations: list[PatchLocation]) -> None:
        """Accumulate a (B, C, i, j, k) tensor (or a dict of them) at the
        patches' locations."""
        tensors = {"__default__": batch} if not isinstance(batch, dict) else batch
        for key, tensor in tensors.items():
            tensor = as_tensor(tensor)
            locs = [
                loc.scaled(self._scale) if self._scale != (1.0, 1.0, 1.0) else loc
                for loc in locations
            ]
            self._ensure_buffer(key, tensor[0])
            tensor = tensor.to(torch.float32)
            if self.overlap_mode == "crop":
                for idx, loc in enumerate(locs):
                    self._add_crop(key, tensor[idx], loc)
                continue
            corners = np.asarray([loc.index for loc in locs], np.int64)
            if self.overlap_mode == "average":
                window = 1.0
            else:  # hann
                window = self._get_hann(tuple(tensor.shape[-3:]), tensor.device)
            self._pending.setdefault(key, []).append((tensor, window, corners))
            self._pending_bytes[key] = (
                self._pending_bytes.get(key, 0) + tensor.numel() * tensor.element_size()
            )
            if self._pending_bytes[key] >= self._flush_bytes:
                self._flush(key)

    def get_output(
        self,
        key: str | None = None,
        *,
        device: bool = False,
        dtype: Any = None,
    ) -> np.ndarray | torch.Tensor:
        """Aggregated (C, I, J, K) volume.

        By default a host numpy array (the one copy to the host). With
        ``device=True`` a tensor on the buffers' device, which never
        aliases the crop buffer, for a consumer on the device (an inverse
        transform, an argmax, a metric). ``dtype`` (torch or numpy) casts
        on the device, before any copy.
        """
        resolved = key if key is not None else "__default__"
        if resolved not in self._outputs:
            available = [k for k in self._outputs if k != "__default__"]
            raise KeyError(f"No output for key {key!r}. Available: {available}")
        self._flush(resolved)
        output = self._outputs[resolved]
        if self.overlap_mode in ("average", "hann"):
            output = output / torch.clamp(self._counts[resolved], min=1e-8)
        else:
            # crop mode: ``output`` is the buffer itself, which a later
            # add_batch writes into (and a CPU tensor's numpy() shares its
            # memory): hand out a copy
            output = output.clone()
        if dtype is not None:
            output = output.to(_torch_dtype(dtype))
        if device:
            return output
        return output.cpu().numpy()

    # --- internals ---

    def _flush(self, key: str) -> None:
        """Add the pending patches in order, one after the other."""
        pending = self._pending.pop(key, None)
        self._pending_bytes.pop(key, None)
        if not pending:
            return
        out, cnt = self._outputs[key], self._counts[key]
        for tensor, window, corners in pending:
            for patch, corner in zip(tensor, corners):
                region = _region(corner, patch.shape[1:], self.spatial_shape)
                out[region] += patch * window
                cnt[region] += window

    def _ensure_buffer(self, key: str, patch: torch.Tensor) -> None:
        if key in self._outputs:
            return
        shape = (patch.shape[0], *self.spatial_shape)
        self._outputs[key] = torch.zeros(shape, dtype=torch.float32, device=patch.device)
        if self.overlap_mode in ("average", "hann"):
            self._counts[key] = torch.zeros(shape, dtype=torch.float32, device=patch.device)

    def _add_crop(self, key: str, patch: torch.Tensor, location: PatchLocation) -> None:
        # trim overlap/2 on each axis, only at faces inside the volume: a
        # patch flush with a volume boundary keeps its full extent there
        trim = (
            np.rint(
                np.asarray(self.patch_overlap, np.float64)
                * np.asarray(self._scale, np.float64)
            ).astype(np.int64)
            // 2
        )
        start = np.asarray(location.index_ini, np.int64)
        stop = np.asarray(location.index_fin, np.int64)
        lo_trim = np.where(start > 0, trim, 0)
        hi_trim = np.where(stop < np.asarray(self.spatial_shape), trim, 0)
        keep = tuple(
            slice(int(lo), int(size - hi))
            for lo, size, hi in zip(lo_trim, location.size, hi_trim)
        )
        cropped = patch[(slice(None), *keep)]
        region = _region(start + lo_trim, cropped.shape[1:], self.spatial_shape)
        self._outputs[key][region] = cropped

    def _get_hann(self, patch_size: tuple[int, int, int], device) -> torch.Tensor:
        cache_key = (patch_size, str(device))
        if cache_key not in self._hann_cache:
            self._hann_cache[cache_key] = torch.as_tensor(
                _build_hann_3d(patch_size), device=device
            )
        return self._hann_cache[cache_key]
