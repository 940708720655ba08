"""Logging setup (parity with reference utils/logging_config.py:11-78).

stdlib logging, idempotent handler install, console + optional UTF-8 file
handler, ``"%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"`` format.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional

_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def setup_logger(
    name: str = "flow_vision",
    level: int = logging.INFO,
    log_file: Optional[str] = None,
    format_string: Optional[str] = None,
) -> logging.Logger:
    """Configure and return a logger instance.

    Idempotent per handler KIND: a console handler is attached once, and a
    file handler is attached the first time a ``log_file`` is requested —
    even if the logger was already console-configured at import time (the
    module-level ``logger`` below would otherwise make main.py's
    ``log_file=`` request a silent no-op).
    """
    log = logging.getLogger(name)
    if not log.handlers:
        # only the first configuration sets the level; later calls (e.g. a
        # lazy get_logger at import time) must not clobber a user's DEBUG
        log.setLevel(level)
    log.propagate = False  # own handlers only; avoids ancestor double-logging
    formatter = logging.Formatter(format_string or _FORMAT, datefmt=_DATEFMT)

    if not any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
        for h in log.handlers
    ):
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(level)
        console.setFormatter(formatter)
        log.addHandler(console)

    if log_file is not None and not any(
        isinstance(h, logging.FileHandler) for h in log.handlers
    ):
        log_path = Path(log_file)
        log_path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setLevel(level)
        fh.setFormatter(formatter)
        log.addHandler(fh)

    return log


def get_logger(name: str = "flow_vision") -> logging.Logger:
    """Get a logger. Dotted children of "flow_vision" carry no handlers of
    their own and propagate to the configured parent, so a file handler
    attached to "flow_vision" captures every module's logs."""
    log = logging.getLogger(name)
    if "." in name and name.startswith("flow_vision"):
        setup_logger("flow_vision")  # ensure the parent is configured
        log.propagate = True
        return log
    if not log.handlers:
        return setup_logger(name)
    return log


logger = setup_logger("flow_vision")
