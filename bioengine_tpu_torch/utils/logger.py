"""Structured logging: own copy of ``bioengine_tpu/utils/logger.py``.

Colored console + plain file formatter, tz-aware timestamps, and a
process-wide registry so per-component log files can be tailed.
"""

from __future__ import annotations

import logging
import sys
from datetime import datetime
from pathlib import Path
from typing import Optional

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"

# component name -> log file path, consulted by Worker.get_logs
LOG_FILE_REGISTRY: dict[str, Path] = {}


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelname, "")
        record.levelcolor = f"{color}{record.levelname}{_RESET}"
        return super().format(record)


def create_logger(
    name: str,
    level: int = logging.INFO,
    log_file: Optional[Path | str] = None,
) -> logging.Logger:
    """Create (or reconfigure) a named logger.

    ``log_file="off"`` (or None) disables the file handler — mirrors the
    reference's worker fixture convention (ref tests/end_to_end/conftest.py).
    """
    logger = logging.getLogger(f"bioengine.{name}")
    logger.setLevel(level)
    logger.propagate = False
    logger.handlers.clear()

    datefmt = "%Y-%m-%d %H:%M:%S %z"
    # stderr, not stdout: CLI/service data output must stay parseable
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(
        _ColorFormatter(
            "%(asctime)s - %(name)s - %(levelcolor)s - %(message)s", datefmt=datefmt
        )
    )
    logger.addHandler(stream)

    if log_file and str(log_file) != "off":
        path = Path(log_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(
            logging.Formatter(
                "%(asctime)s - %(name)s - %(levelname)s - %(message)s", datefmt=datefmt
            )
        )
        logger.addHandler(fh)
        LOG_FILE_REGISTRY[name] = path

    return logger


def read_log_tail(name: str, max_lines: int = 200) -> str:
    """Tail a registered component log file (admin ``get_logs`` endpoint)."""
    path = LOG_FILE_REGISTRY.get(name)
    if path is None or not path.exists():
        return ""
    from collections import deque

    with path.open(errors="replace") as f:
        return "\n".join(deque(f, maxlen=max_lines)).rstrip("\n")


def timestamp() -> str:
    return datetime.now().astimezone().isoformat()
