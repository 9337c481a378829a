"""Shared logging setup.

Counterpart of the reference's ``utils/logging.py``: one stderr handler
(and an optional file) per named logger, set up once.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

__all__ = ["setup_logger"]

_FMT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def setup_logger(name: str = "ant_tpu",
                 log_file: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    logger.propagate = False
    return logger
