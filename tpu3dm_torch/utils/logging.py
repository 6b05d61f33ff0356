"""Per-module logger factory (the port's copy of tpu3dm/utils/logging.py).

INFO level, a stderr handler with the reference's record format, and a
duplicate-handler guard.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logging(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.hasHandlers():
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    return logger
