"""3D MedMNIST v2 loaders (Zenodo npz archives).

The port's copy of ``torchio_tpu/datasets/medmnist.py``.
"""

from __future__ import annotations

import numpy as np

from ..data.image import ScalarImage
from ..data.subject import Subject
from ..utils.download import download_url, get_cache_dir


_SPLIT_ALIASES = {"training": "train", "validation": "val", "testing": "test"}
_ZENODO = "https://zenodo.org/record/5208230/files/{name}.npz?download=1"

#: dataset key -> short description (all are 28^3 volumes)
DATASETS = {
    "organmnist3d": "3D organ classification volumes",
    "nodulemnist3d": "lung nodule volumes",
    "adrenalmnist3d": "adrenal gland shape volumes",
    "fracturemnist3d": "rib fracture volumes",
    "vesselmnist3d": "brain vessel shape volumes",
    "synapsemnist3d": "electron-microscopy synapse volumes",
}


def _load_medmnist(name: str, split: str) -> list[Subject]:
    split = _SPLIT_ALIASES.get(split, split)
    if split not in ("train", "val", "test"):
        raise ValueError(
            f"Split must be train/val/test (or their long forms), got {split!r}"
        )
    root = get_cache_dir() / "MedMNIST"
    download_url(_ZENODO.format(name=name), root, filename=f"{name}.npz")
    archive = np.load(root / f"{name}.npz")
    pairs = zip(archive[f"{split}_images"], archive[f"{split}_labels"])
    return [
        Subject(
            image=ScalarImage(volume[np.newaxis].astype(np.float32)),
            labels=np.array(label),
        )
        for volume, label in pairs
    ]


def _make_loader(name: str):
    def loader(split: str = "train") -> list[Subject]:
        return _load_medmnist(name, split)

    loader.__name__ = name.replace("mnist3d", "_mnist_3d")
    loader.__doc__ = f"MedMNIST v2: {DATASETS[name]}."
    return loader


organ_mnist_3d = _make_loader("organmnist3d")
nodule_mnist_3d = _make_loader("nodulemnist3d")
adrenal_mnist_3d = _make_loader("adrenalmnist3d")
fracture_mnist_3d = _make_loader("fracturemnist3d")
vessel_mnist_3d = _make_loader("vesselmnist3d")
synapse_mnist_3d = _make_loader("synapsemnist3d")
