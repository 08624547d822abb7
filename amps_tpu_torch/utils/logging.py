"""Logging with µs UTC timestamps, the PyTorch port of
``amps_tpu.utils.logging`` -- the role of LOG_WARNING/LOG_DEBUG
(lib/utils.h:18-19, getstamp lib/utils.cc:111), minus the
not-thread-safe static buffer the reference warns about.  The logger is
named ``amps_tpu_torch``."""

from __future__ import annotations

import logging
import time

LOGGER_NAME = "amps_tpu_torch"


class _UTCMicroFormatter(logging.Formatter):
    def formatTime(self, record, datefmt=None):
        t = time.gmtime(record.created)
        return (time.strftime("%Y-%m-%d %H:%M:%S", t)
                + f".{int((record.created % 1) * 1e6):06d}")


def get_logger(name: str = LOGGER_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(_UTCMicroFormatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def log_debug(msg: str, *args) -> None:
    get_logger().debug(msg, *args)


def log_warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)
