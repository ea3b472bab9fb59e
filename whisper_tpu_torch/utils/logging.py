"""Leveled, colored logging on the standard library.

Port of ``whisper_tpu/utils/logging.py``: one stderr handler per logger,
added once, colored on a terminal; the level comes from ``WHISPER_TPU_LOG``
(default INFO).
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.ERROR: "\033[31m",
    logging.WARNING: "\033[33m",
    logging.INFO: "\033[32m",
    logging.DEBUG: "\033[36m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}" if color else msg
        return msg


def get_logger(name: str = "whisper_tpu_torch") -> logging.Logger:
    """The logger ``name``, set up on its first call and returned as it is
    on every later one."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_ColorFormatter("[%(levelname).1s %(name)s] %(message)s"))
        logger.addHandler(h)
        level = os.environ.get("WHISPER_TPU_LOG", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
        logger.propagate = False
    return logger
