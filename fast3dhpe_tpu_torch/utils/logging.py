"""Logging setup. Port of fast3dhpe_tpu/utils/logging.py."""

from __future__ import annotations

import logging

_LOGGER_NAME = "fast3dhpe_tpu_torch"


def setup_logger(level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    ch = logging.StreamHandler()
    ch.setLevel(level)
    ch.setFormatter(logging.Formatter(
        "%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(ch)
    logger.propagate = False
    return logger
