"""Library logging: silent by default, opt-in through :func:`enable_logging`
(the port's copy of ``torchio_tpu/logging.py``, on the standard library's
``logging``; ``rich`` formatting when that package is installed)."""

from __future__ import annotations

import logging as _logging

logger = _logging.getLogger("torchio_tpu_torch")
logger.addHandler(_logging.NullHandler())


def enable_logging(level: str | int = "INFO", rich: bool = True) -> None:
    """Turn on the package's log output (optionally with rich formatting)."""
    logger.setLevel(level)
    for handler in list(logger.handlers):
        if not isinstance(handler, _logging.NullHandler):
            logger.removeHandler(handler)
    handler: _logging.Handler
    if rich:
        try:
            from rich.logging import RichHandler

            handler = RichHandler(rich_tracebacks=True)
        except ImportError:
            handler = _logging.StreamHandler()
    else:
        handler = _logging.StreamHandler()
    handler.setLevel(level)
    logger.addHandler(handler)


def disable_logging() -> None:
    """Restore the library-default silence."""
    for handler in list(logger.handlers):
        if not isinstance(handler, _logging.NullHandler):
            logger.removeHandler(handler)
    logger.setLevel(_logging.WARNING)
