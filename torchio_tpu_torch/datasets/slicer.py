"""3D Slicer sample datasets (NRRD files).

The port's copy of ``torchio_tpu/datasets/slicer.py``.
"""

from __future__ import annotations

import urllib.parse

from ..data.image import ScalarImage
from ..data.subject import Subject
from ..utils.download import download_url, get_cache_dir

SLICER_URL = "https://github.com/Slicer/SlicerTestingData/releases/download/"

URLS_DICT = {
    "MRHead": (
        ("MR-head.nrrd",),
        ("SHA256/cc211f0dfd9a05ca3841ce1141b292898b2dd2d3f08286affadf823a7e58df93",),
    ),
    "DTIBrain": (
        ("DTI-Brain.nrrd",),
        ("SHA256/5858240f58d2d93f0e75c1f16a01f29023e9e0b5a7a1926f631f1e46e17eed16",),
    ),
    "CTChest": (
        ("CT-chest.nrrd",),
        ("SHA256/4507b664690840abb6cb9af2d919377ffc4ef75b167cb6fd0f747befdb12e38e",),
    ),
}


class Slicer(Subject):
    """Sample data provided by 3D Slicer, read as NRRD files."""

    def __init__(self, name: str = "MRHead") -> None:
        if name not in URLS_DICT:
            raise ValueError(f"name must be one of {sorted(URLS_DICT)}, got {name!r}")
        filenames, url_files = URLS_DICT[name]
        root = get_cache_dir() / "slicer"
        for filename, url_file in zip(filenames, url_files):
            filename = filename.replace("-", "_")
            url = urllib.parse.urljoin(SLICER_URL, url_file)
            download_url(url, root, filename=filename)
        stem = filename.split(".")[0]
        super().__init__(**{stem: ScalarImage(root / filename)})
