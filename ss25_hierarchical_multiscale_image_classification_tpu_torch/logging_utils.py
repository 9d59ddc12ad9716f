"""Logging under the ``hipac`` logger tree, and a wall-clock stage timer.

Copy of the JAX package's ``logging_utils.py``. Both write under the same
``hipac`` logger; whichever is imported first installs the one handler.
"""

from __future__ import annotations

import logging
import sys
import time

_COLORS = {
    logging.DEBUG: "\033[94m",  # blue
    logging.INFO: "\033[92m",  # green
    logging.WARNING: "\033[93m",  # yellow
    logging.ERROR: "\033[91m",  # red
    logging.CRITICAL: "\033[95m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        level = f"{color}[{record.levelname}]{_RESET}"
        return f"{level} {record.name}: {record.getMessage()}"


def get_logger(name: str = "hipac") -> logging.Logger:
    root = logging.getLogger("hipac")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_ColorFormatter())
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    if name != "hipac" and not name.startswith("hipac."):
        name = f"hipac.{name}"
    return logging.getLogger(name)


class Timer:
    """Wall-clock stage timer, logged at INFO on exit."""

    def __init__(self, name: str, logger: logging.Logger | None = None):
        self.name = name
        self.logger = logger or get_logger("timer")
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._start
        self.logger.info("%s took %.3fs", self.name, self.elapsed)
