"""Dataset download and caching.

The port's copy of ``torchio_tpu/utils/download.py``: the per-user cache
directory, md5 integrity checks, ``download_url`` (with an https -> http
retry that warns when there is no checksum), and zip/tar/gz extraction
that refuses members escaping the target directory.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import shutil
import tarfile
import urllib.error
import urllib.request
import zipfile
from pathlib import Path


def get_cache_dir() -> Path:
    """Per-user cache directory for downloaded datasets."""
    try:
        import platformdirs

        return Path(platformdirs.user_cache_dir("torchio_tpu"))
    except ImportError:
        return Path(os.path.expanduser("~/.cache/torchio_tpu"))


def _md5(path: Path, chunk_size: int = 1024 * 1024) -> str:
    digest = hashlib.md5()
    with open(path, "rb") as f:
        while chunk := f.read(chunk_size):
            digest.update(chunk)
    return digest.hexdigest()


def check_integrity(path: Path, md5: str | None = None) -> bool:
    if not Path(path).is_file():
        return False
    if md5 is None:
        return True
    return _md5(Path(path)) == md5


def download_url(
    url: str,
    root: str | Path,
    filename: str | None = None,
    md5: str | None = None,
) -> Path:
    """Download ``url`` into ``root`` (md5-checked; https->http retry)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    if filename is None:
        filename = url.rstrip("/").split("/")[-1]
    path = root / filename
    if check_integrity(path, md5):
        return path
    try:
        urllib.request.urlretrieve(url, path)  # noqa: S310
    except (urllib.error.URLError, OSError):
        if url.startswith("https://"):
            fallback = "http://" + url[len("https://") :]
            if md5 is None:
                import warnings

                warnings.warn(
                    f"https failed; retrying over plain http without an "
                    f"md5 checksum to verify the payload: {fallback}",
                    RuntimeWarning,
                    stacklevel=2,
                )
            urllib.request.urlretrieve(fallback, path)  # noqa: S310
        else:
            raise
    if not check_integrity(path, md5):
        raise RuntimeError(f"File {path} not found or corrupted after download")
    return path


def extract_archive(path: str | Path, to: str | Path | None = None) -> Path:
    """Extract zip / tar(.gz|.bz2) / .gz archives."""
    path = Path(path)
    to = Path(to) if to is not None else path.parent
    name = path.name.lower()
    if name.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            root = to.resolve()
            for member in z.namelist():
                target = (to / member).resolve()
                if not target.is_relative_to(root):
                    raise RuntimeError(
                        f"zip member escapes extraction root: {member!r}"
                    )
            z.extractall(to)  # noqa: S202
    elif name.endswith((".tar", ".tar.gz", ".tgz", ".tar.bz2")):
        with tarfile.open(path) as t:
            # filter="data" blocks path traversal, symlink escapes,
            # device nodes (PEP 706; default only from Python 3.14).
            t.extractall(to, filter="data")
    elif name.endswith(".gz"):
        out = to / path.name[:-3]
        with gzip.open(path, "rb") as src, open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)
        return out
    else:
        raise ValueError(f"Unknown archive type: {path}")
    return to


def download_and_extract_archive(
    url: str,
    download_root: str | Path,
    extract_root: str | Path | None = None,
    filename: str | None = None,
    md5: str | None = None,
) -> Path:
    archive = download_url(url, download_root, filename=filename, md5=md5)
    return extract_archive(archive, extract_root or download_root)
