"""Utilities: dataset download and caching."""

from .download import (
    check_integrity,
    download_and_extract_archive,
    download_url,
    extract_archive,
    get_cache_dir,
)

__all__ = [
    "check_integrity",
    "download_and_extract_archive",
    "download_url",
    "extract_archive",
    "get_cache_dir",
]
