"""PCA over channels (feature-map visualisation).

Counterpart of ``torchio_tpu/transforms/intensity/pca.py``: the centred
(voxels, C) matrix of each element and its C x C gram in float32 on the
device, the gram's eigenvectors on the host, then the projection onto
the leading ones, whitening, normalisation by the first component's
standard deviation (ddof 0), the value range and the clip on the device.

The eigendecomposition is ``scipy.linalg.eigh(gram, driver="evd")`` on
the float32 gram (LAPACK's ``ssyevd``, which JAX's CPU ``eigh`` calls):
it gives the JAX package's eigenvectors with their signs, where
``torch.linalg.eigh`` picks the other sign for some grams and so flips
components of the output. A gram is C x C floats: one small copy to the
host an element, and the eigenvectors back.

A sharded batch projects each rank's rows: over B with no collective
(each element's statistics are its own); along J each rank's rows are
gathered whole along J over ``space`` (one ``all_gather``, never over
``data``) and each rank keeps its columns of the result.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.linalg
import torch

from ...data.batch import SubjectsBatch
from ...parallel.mesh import map_rows
from ..transform import IntensityTransform


def gram_eigh(gram: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ascending eigenvalues and eigenvectors (columns) of a symmetric
    float32 matrix, as ``jnp.linalg.eigh`` computes them on the CPU."""
    return scipy.linalg.eigh(np.asarray(gram, np.float32), driver="evd")


class PCA(IntensityTransform):
    r"""Project the channel dimension onto its leading principal components."""

    takes_sharded = True

    def __init__(
        self,
        num_components: int = 3,
        *,
        whiten: bool = True,
        normalize: bool = True,
        values_range: tuple[float, float] = (-2.3, 2.3),
        clip: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if num_components < 1:
            raise ValueError(f"num_components must be >= 1, got {num_components}")
        self.num_components = num_components
        self.whiten = whiten
        self.normalize = normalize
        self.values_range = values_range
        self.clip = clip

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in self._get_images(batch).values():
            img_batch.data = map_rows(self._pca_rows, img_batch.data)
        return batch

    def _pca_rows(self, data: torch.Tensor) -> torch.Tensor:
        if data.shape[0] == 0:
            return data.new_empty((0, self.num_components, *data.shape[2:]), dtype=torch.float32)
        return torch.stack([self._pca_single(data[i]) for i in range(data.shape[0])])

    def _pca_single(self, tensor: torch.Tensor) -> torch.Tensor:
        c, si, sj, sk = tensor.shape
        if c < self.num_components:
            raise ValueError(
                f"Image has {c} channels but num_components={self.num_components};"
                " need at least as many channels as components."
            )
        flat = tensor.to(torch.float32).reshape(c, -1).T  # (voxels, C)
        centered = flat - flat.mean(dim=0, keepdim=True)
        gram = (centered.T @ centered).cpu().numpy()
        eigvals, eigvecs = gram_eigh(gram)
        order = np.argsort(eigvals, kind="stable")[::-1][: self.num_components]
        v = torch.as_tensor(np.ascontiguousarray(eigvecs[:, order]), device=tensor.device)
        s = np.sqrt(np.clip(eigvals[order], 0.0, None))
        projected = centered @ v
        if self.whiten:
            n = flat.shape[0]
            denom = (n - 1) ** 0.5 if n > 1 else 1.0
            std = np.clip(s / np.float32(denom), 1e-8, None).astype(np.float32)
            projected = projected / torch.as_tensor(std, device=tensor.device)
        if self.normalize and projected.shape[1] > 0:
            first_std = torch.clamp(torch.std(projected[:, 0], correction=0), min=1e-8)
            projected = projected / first_std
        lo, hi = self.values_range
        projected = (projected - lo) / (hi - lo)
        if self.clip:
            projected = torch.clamp(projected, 0.0, 1.0)
        return projected.T.reshape(self.num_components, si, sj, sk)
