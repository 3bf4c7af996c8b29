"""Affine-transform files: ITK ``.tfm`` (text) and ``.h5``, NiftyReg
``.txt``/``.trsf``.

The port's copy of ``torchio_tpu/io/matrix.py``: a (4, 4) float64 RAS
matrix in, the ITK convention (LPS, the inverse direction) on disk.
``.h5`` needs the optional ``h5py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..external.imports import get_h5py
from .nifti import _host_array

FLIPXY_44 = np.diag([-1.0, -1.0, 1.0, 1.0])


def _to_itk_convention(matrix: np.ndarray) -> np.ndarray:
    """RAS affine -> ITK (LPS, inverse-direction) parameters."""
    matrix = FLIPXY_44 @ np.asarray(matrix, np.float64) @ FLIPXY_44
    return np.linalg.inv(matrix)


def _from_itk_convention(matrix: np.ndarray) -> np.ndarray:
    """ITK LPS parameters -> RAS affine."""
    matrix = np.asarray(matrix, np.float64) @ FLIPXY_44
    matrix = FLIPXY_44 @ matrix
    return np.linalg.inv(matrix)


def _params_to_homogeneous(params: np.ndarray, fixed: np.ndarray | None) -> np.ndarray:
    rotation = params[:9].reshape(3, 3)
    translation = params[9:12]
    m = np.eye(4)
    m[:3, :3] = rotation
    if fixed is not None and np.any(fixed):
        # ITK stores an optional center of rotation; fold it into the
        # translation: t' = t + c - R @ c
        c = np.asarray(fixed, np.float64)[:3]
        translation = translation + c - rotation @ c
    m[:3, 3] = translation
    return m


def _read_itk_tfm(path: Path) -> np.ndarray:
    params = None
    fixed = None
    for line in path.read_text().splitlines():
        line = line.strip()
        if line.lower().startswith("parameters:"):
            params = np.array([float(v) for v in line.split(":", 1)[1].split()])
        elif line.lower().startswith("fixedparameters:"):
            fixed = np.array([float(v) for v in line.split(":", 1)[1].split()])
    if params is None or len(params) < 12:
        raise ValueError(f"Could not parse ITK transform parameters from {path}")
    return _params_to_homogeneous(params, fixed)


def _read_itk_h5(path: Path) -> np.ndarray:
    h5py = get_h5py()

    with h5py.File(path, "r") as f:
        group = f["TransformGroup"]
        # first stored transform (key "0" is metadata in some files)
        keys = sorted(k for k in group.keys() if k != "0") or list(group.keys())
        tgroup = group[keys[0]]
        params = np.asarray(tgroup["TransformParameters"], np.float64)
        fixed = (
            np.asarray(tgroup["TransformFixedParameters"], np.float64)
            if "TransformFixedParameters" in tgroup
            else None
        )
    if params.size < 12:
        raise ValueError(f"Unsupported transform parameter count in {path}")
    return _params_to_homogeneous(params, fixed)


def read_matrix(path) -> np.ndarray:
    """Read an affine transform file; returns a (4, 4) float64 RAS matrix."""
    path = Path(path)
    if path.suffix == ".tfm":
        lps = _read_itk_tfm(path)
        return _from_itk_convention(lps)
    if path.suffix == ".h5":
        lps = _read_itk_h5(path)
        return _from_itk_convention(lps)
    if path.suffix in (".txt", ".trsf"):
        return np.linalg.inv(np.loadtxt(path).astype(np.float64))
    raise ValueError(f'Unknown suffix for transform file: "{path.suffix}"')


def write_matrix(matrix, path) -> None:
    """Write a (4, 4) RAS affine to .tfm / .txt / .trsf."""
    path = Path(path)
    matrix = _host_array(matrix).astype(np.float64)
    if path.suffix == ".tfm":
        itk = _to_itk_convention(matrix)
        params = list(itk[:3, :3].ravel()) + list(itk[:3, 3])
        text = (
            "#Insight Transform File V1.0\n"
            "#Transform 0\n"
            "Transform: AffineTransform_double_3_3\n"
            f"Parameters: {' '.join(f'{v:.17g}' for v in params)}\n"
            "FixedParameters: 0 0 0\n"
        )
        path.write_text(text)
    elif path.suffix in (".txt", ".trsf"):
        np.savetxt(path, np.linalg.inv(matrix), fmt="%.8f")
    elif path.suffix == ".h5":
        h5py = get_h5py()

        itk = _to_itk_convention(matrix)
        params = np.concatenate([itk[:3, :3].ravel(), itk[:3, 3]])
        with h5py.File(path, "w") as f:
            group = f.create_group("TransformGroup").create_group("1")
            group.create_dataset(
                "TransformType",
                data=np.bytes_("AffineTransform_double_3_3"),
            )
            group.create_dataset("TransformParameters", data=params)
            group.create_dataset("TransformFixedParameters", data=np.zeros(3))
    else:
        raise ValueError(f'Unknown suffix for transform file: "{path.suffix}"')
