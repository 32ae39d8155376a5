"""Logging helpers (counterpart of ``mxnet_tpu/log.py``, parity:
python/mxnet/log.py): ``get_logger`` with the colored level formatter the
reference's examples configure."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger", "DEBUG", "INFO", "WARNING", "ERROR",
           "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
NOTSET = logging.NOTSET

PY3 = True  # parity constant (reference exports it)


class _Formatter(logging.Formatter):
    """parity: log.py _Formatter — level-colored prefix when the stream
    is a tty, plain otherwise."""

    _COLORS = {logging.WARNING: "\x1b[0;33m", logging.ERROR: "\x1b[0;31m",
               logging.CRITICAL: "\x1b[0;35m", logging.DEBUG: "\x1b[0;34m"}

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def format(self, record):
        fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
        if self.colored and record.levelno in self._COLORS:
            fmt = (self._COLORS[record.levelno] +
                   "%(asctime)s %(levelname)s %(name)s:\x1b[0m %(message)s")
        self._style._fmt = fmt
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """parity: log.py getLogger — a logger with the framework formatter
    attached once."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxtpu_handler", None) is None:
        if filename:
            mode = filemode or "a"
            handler = logging.FileHandler(filename, mode)
            handler.setFormatter(_Formatter(colored=False))
        else:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                _Formatter(colored=getattr(sys.stderr, "isatty",
                                           lambda: False)()))
        logger.addHandler(handler)
        logger._mxtpu_handler = handler
    logger.setLevel(level)
    return logger


getLogger = get_logger
