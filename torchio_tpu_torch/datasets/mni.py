"""MNI atlases: Colin27, ICBM 2009c, Pediatric, Sheep.

The port's copy of ``torchio_tpu/datasets/mni.py``: the same download
URLs and file layouts; the data are fetched on first use and cached.
"""

from __future__ import annotations

import urllib.parse

from ..data.image import LabelMap, ScalarImage
from ..data.subject import Subject
from ..utils.download import download_and_extract_archive, get_cache_dir


class SubjectMNI(Subject):
    """Base class for Montreal Neurological Institute atlases."""

    url_base = "http://packages.bic.mni.mcgill.ca/mni-models/"
    name: str

    @property
    def download_root(self):
        return get_cache_dir() / self.name

    def _fetch(self, url: str, filename: str) -> None:
        if not self.download_root.is_dir():
            download_and_extract_archive(
                url, download_root=self.download_root, filename=filename
            )


class Colin27(SubjectMNI):
    """Colin27 average-brain template (1998 or 2008 version)."""

    def __init__(self, version: int = 1998) -> None:
        if version not in (1998, 2008):
            raise ValueError(f'Version must be 1998 or 2008, not "{version}"')
        self.version = version
        self.name = f"mni_colin27_{version}_nifti"
        filename = f"{self.name}.zip"
        url = urllib.parse.urljoin(
            urllib.parse.urljoin(self.url_base, "colin27/"), filename
        )
        self._fetch(url, filename)
        root = self.download_root
        if version == 1998:
            kwargs = {
                "t1": ScalarImage(self._find(root, "colin27_t1_tal_lin")),
                "head": LabelMap(self._find(root, "colin27_t1_tal_lin_headmask")),
                "brain": LabelMap(self._find(root, "colin27_t1_tal_lin_mask")),
            }
        else:
            kwargs = {
                "t1": ScalarImage(self._find(root, "colin27_t1_tal_hires")),
                "t2": ScalarImage(self._find(root, "colin27_t2_tal_hires")),
                "pd": ScalarImage(self._find(root, "colin27_pd_tal_hires")),
                "cls": LabelMap(self._find(root, "colin27_cls_tal_hires")),
            }
        super().__init__(**kwargs)

    @staticmethod
    def _find(root, stem):
        for suffix in (".nii.gz", ".nii"):
            path = root / f"{stem}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"{stem} not found under {root}")


class ICBM2009CNonlinearSymmetric(SubjectMNI):
    """ICBM 152 2009c nonlinear symmetric template (1 mm)."""

    def __init__(self, load_4d_tissues: bool = True) -> None:
        self.name = "mni_icbm152_nlin_sym_09c_nifti"
        url = urllib.parse.urljoin(
            "http://www.bic.mni.mcgill.ca/~vfonov/icbm/2009/", f"{self.name}.zip"
        )
        self._fetch(url, f"{self.name}.zip")
        root = self.download_root / "mni_icbm152_nlin_sym_09c"
        if not root.is_dir():
            root = self.download_root
        p = "mni_icbm152"
        s = "tal_nlin_sym_09c.nii"

        def img(mod):
            return root / f"{p}_{mod}_{s}"

        kwargs = {
            "t1": ScalarImage(img("t1")),
            "eyes": ScalarImage(root / f"{p}_t1_{s[:-4]}_eye_mask.nii"),
            "face": ScalarImage(root / f"{p}_t1_{s[:-4]}_face_mask.nii"),
            "brain": LabelMap(root / f"{p}_t1_{s[:-4]}_mask.nii"),
            "t2": ScalarImage(img("t2")),
            "pd": ScalarImage(img("pd")),
        }
        if load_4d_tissues:
            kwargs["tissues"] = LabelMap(root / f"{p}_{s[:-4]}_tissues.nii" if (root / f"{p}_{s[:-4]}_tissues.nii").is_file() else img("csf"))
        super().__init__(**{k: v for k, v in kwargs.items() if v.path is None or v.path.exists()})


class Pediatric(SubjectMNI):
    """NIHPD pediatric atlases (age-range specific)."""

    def __init__(self, years, symmetric: bool = False) -> None:
        sym = "sym" if symmetric else "asym"
        ranges = {
            (4.5, 18.5): "04.5-18.5",
            (4.5, 8.5): "04.5-08.5",
            (7, 11): "07.0-11.0",
            (7.5, 13.5): "07.5-13.5",
            (10, 14): "10.0-14.0",
            (13, 18.5): "13.0-18.5",
        }
        if tuple(years) not in ranges:
            raise ValueError(f"years must be one of {sorted(ranges)}, got {years}")
        age = ranges[tuple(years)]
        self.name = f"nihpd_{sym}_{age}_nifti"
        url = urllib.parse.urljoin(
            "http://www.bic.mni.mcgill.ca/~vfonov/nihpd/obj1/", f"{self.name}.zip"
        )
        self._fetch(url, f"{self.name}.zip")
        root = self.download_root
        prefix = f"nihpd_{sym}_{age}"
        super().__init__(
            t1=ScalarImage(root / f"{prefix}_t1w.nii"),
            t2=ScalarImage(root / f"{prefix}_t2w.nii"),
            pd=ScalarImage(root / f"{prefix}_pdw.nii"),
            mask=LabelMap(root / f"{prefix}_mask.nii"),
        )


class Sheep(SubjectMNI):
    """MNI sheep brain template."""

    def __init__(self) -> None:
        self.name = "NIFTI_ovine_auxiliary_masks"
        url = urllib.parse.urljoin(
            urllib.parse.urljoin(self.url_base, "sheep/"), f"{self.name}.zip"
        )
        self._fetch(url, f"{self.name}.zip")
        t1 = next(self.download_root.rglob("*.nii*"))
        super().__init__(t1=ScalarImage(t1))
