"""Logging setup with colored console output and benchmark loggers.

Named loggers under the ``realhf_tpu_torch`` namespace, a separate
"benchmark" logger type that can be silenced on its own, and
environment-controlled verbosity. ANSI codes are emitted directly when
the stream is a TTY.
"""

import logging as _logging
import os
import sys
from typing import Optional

LOG_FORMAT = "%(asctime)s.%(msecs)03d %(name)s %(levelname)s: %(message)s"
DATE_FORMAT = "%Y%m%d-%H:%M:%S"

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"
_ROOT = "realhf_tpu_torch"


class _ColorFormatter(_logging.Formatter):

    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname)
            if color:
                msg = f"{color}{msg}{_RESET}"
        return msg


_configured = False


def _configure_root():
    global _configured
    if _configured:
        return
    level = os.environ.get("REALHF_TORCH_LOG_LEVEL", "INFO").upper()
    handler = _logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(_ColorFormatter(fmt=LOG_FORMAT, datefmt=DATE_FORMAT))
    root = _logging.getLogger(_ROOT)
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
    _configured = True


def getLogger(name: Optional[str] = None,
              type_: Optional[str] = None) -> _logging.Logger:
    """Get a logger under the framework namespace. ``type_`` may be
    "benchmark"; those loggers are silenced by
    REALHF_TORCH_SILENCE_BENCHMARK=1."""
    _configure_root()
    if name is None:
        return _logging.getLogger(_ROOT)
    logger = _logging.getLogger(f"{_ROOT}.{name}")
    if (type_ == "benchmark"
            and os.environ.get("REALHF_TORCH_SILENCE_BENCHMARK") == "1"):
        logger.setLevel(_logging.WARNING)
    return logger
