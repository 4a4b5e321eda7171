"""Colored, cached console logger.

The port's copy of ``openvivqa_tpu/logging_utils.py``.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        base = super().format(record)
        if color and sys.stderr.isatty():
            return f"{color}{base}{_RESET}"
        return base


@functools.lru_cache(maxsize=None)
def setup_logger(
    name: str = "openvivqa_tpu_torch",
    output: Optional[str] = None,
    rank: int = 0,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setLevel(logging.DEBUG)
    handler.setFormatter(
        _ColorFormatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S")
    )
    logger.addHandler(handler)

    if output is not None:
        filename = output
        if not filename.endswith(".log"):
            filename = os.path.join(filename, "log.txt")
        if rank > 0:
            filename = f"{filename}.rank{rank}"
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        file_handler = logging.FileHandler(filename)
        file_handler.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s")
        )
        logger.addHandler(file_handler)

    return logger
