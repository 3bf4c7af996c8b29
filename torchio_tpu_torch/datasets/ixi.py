"""IXI brain MRI dataset loaders.

The port's copy of ``torchio_tpu/datasets/ixi.py``: the full IXI
tarballs a modality, and the small ixi_tiny teaching subset.
"""

from __future__ import annotations

from pathlib import Path

from ..data.image import LabelMap, ScalarImage
from ..data.subject import Subject
from ..utils.download import (
    download_and_extract_archive,
    download_url,
    extract_archive,
    get_cache_dir,
)

_IXI_URL = (
    "http://biomedic.doc.ic.ac.uk/brain-development/downloads/IXI/IXI-{modality}.tar"
)
_IXI_TINY_URL = "https://www.dropbox.com/s/ogxjwjxdv5mieah/ixi_tiny.zip?dl=1"


def _subject_id(path: Path) -> str:
    return path.name.split("-")[0]


def ixi(
    root: str | Path | None = None,
    modalities: tuple[str, ...] = ("T1",),
    download: bool = False,
) -> list[Subject]:
    """Subjects with the requested modalities from the full IXI dataset."""
    root = Path(root) if root is not None else get_cache_dir() / "ixi"
    for modality in modalities:
        mod_dir = root / modality
        if not mod_dir.is_dir():
            if not download:
                raise FileNotFoundError(
                    f"{mod_dir} not found; pass download=True to fetch IXI-{modality}"
                )
            url = _IXI_URL.format(modality=modality)
            archive = download_url(url, root, filename=f"IXI-{modality}.tar")
            mod_dir.mkdir(parents=True, exist_ok=True)
            extract_archive(archive, mod_dir)
    per_subject: dict[str, dict[str, ScalarImage]] = {}
    for modality in modalities:
        for path in sorted((root / modality).glob("*.nii.gz")):
            per_subject.setdefault(_subject_id(path), {})[modality.lower()] = (
                ScalarImage(path)
            )
    subjects = []
    for sid, images in per_subject.items():
        if len(images) == len(modalities):
            subjects.append(Subject(subject_id=sid, **images))
    return subjects


def ixi_tiny(
    root: str | Path | None = None,
    download: bool = False,
) -> list[Subject]:
    """566 tiny (83x44x55) paired T1 + brain-mask subjects."""
    root = Path(root) if root is not None else get_cache_dir() / "ixi_tiny"
    if not (root / "image").is_dir():
        if not download:
            raise FileNotFoundError(
                f"{root} not found; pass download=True to fetch ixi_tiny"
            )
        download_and_extract_archive(
            _IXI_TINY_URL, download_root=root, filename="ixi_tiny.zip"
        )
    image_dir = root / "image"
    label_dir = root / "label"
    if not image_dir.is_dir():  # archive nests a folder
        inner = next(root.glob("*/image"), None)
        if inner is not None:
            image_dir = inner
            label_dir = inner.parent / "label"
    subjects = []
    for image_path in sorted(image_dir.glob("*.nii.gz")):
        label_path = label_dir / image_path.name
        if not label_path.is_file():
            continue
        subjects.append(
            Subject(
                subject_id=_subject_id(image_path),
                image=ScalarImage(image_path),
                label=LabelMap(label_path),
            )
        )
    return subjects
