"""ITK-SNAP sample subjects (www.itksnap.org), table-driven.

The port's copy of ``torchio_tpu/datasets/itk_snap.py``: each dataset is
a spec, its NITRC release code and a mapping of subject keys to
(filename, is_label) pairs; one downloader builds the Subject from it.
"""

from __future__ import annotations

import urllib.parse

from ..data.image import LabelMap, ScalarImage
from ..data.subject import Subject
from ..utils.download import download_and_extract_archive, get_cache_dir

_NITRC = "https://www.nitrc.org/frs/download.php/"

#: dataset name -> (release code, {key: (relative filename, is_label)})
_SPECS: dict[str, tuple[str, dict[str, tuple[str, bool]]]] = {
    "braintumor": (
        "10793",
        {
            "flair": ("flair.nii.gz", False),
            "t1": ("t1.nii.gz", False),
            "t1ce": ("t1ce.nii.gz", False),
            "t2": ("t2.nii.gz", False),
            "seg": ("seg.nii.gz", True),
        },
    ),
    "t1t2": (
        "10794",
        {"t1": ("t1.nii.gz", False), "t2": ("t2.nii.gz", False)},
    ),
    "bav": (
        "10795",
        {"image": ("bav01.nii.gz", False), "seg": ("bav01_seg.nii.gz", True)},
    ),
}


class SubjectITKSNAP(Subject):
    """Base for ITK-SNAP sample data; subclasses pick a ``_SPECS`` entry."""

    dataset_name: str = ""

    def __init__(self) -> None:
        name = self.dataset_name
        code, files = _SPECS[name]
        root = get_cache_dir() / name
        if not root.is_dir():
            download_and_extract_archive(
                urllib.parse.urljoin(_NITRC, f"{code}/{name}.zip"),
                download_root=root,
                filename=f"{name}.zip",
            )
        self.name = name
        self.download_root = root
        images = {
            key: (LabelMap if is_label else ScalarImage)(root / name / fname)
            for key, (fname, is_label) in files.items()
        }
        super().__init__(**images)


class BrainTumor(SubjectITKSNAP):
    """Multi-modal MRI with glioblastoma segmentation."""

    dataset_name = "braintumor"


class T1T2(SubjectITKSNAP):
    """Paired T1 and T2 acquisitions."""

    dataset_name = "t1t2"


class AorticValve(SubjectITKSNAP):
    """Time-resolved aortic valve CT with segmentations."""

    dataset_name = "bav"
