"""Two-tier logging control (reference `WorkflowUtils.modifyLogging`,
`workflow/WorkflowUtils.scala:277-288`).

Port of ``predictionio_tpu/utils/logging.py``: the root logger and a set
of "chatty" third-party loggers move together; verbose lifts everything,
non-verbose keeps the chatty ones at WARNING so workflow output stays
readable.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

__all__ = ["setup_logging", "modify_logging", "CHATTY_LOGGERS"]

# the PyTorch equivalents of the reference's chatty Spark/HBase loggers
CHATTY_LOGGERS = ("torch",)

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def setup_logging(
    verbose: bool = False,
    debug: bool = False,
    stream=None,
    fmt: Optional[str] = None,
) -> None:
    """Install a stderr handler once and apply the verbosity tiers."""
    root = logging.getLogger()
    if not any(
        isinstance(h, logging.StreamHandler) for h in root.handlers
    ):
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(fmt or _FORMAT))
        root.addHandler(h)
    modify_logging(verbose=verbose, debug=debug)


def modify_logging(verbose: bool = False, debug: bool = False) -> None:
    """Root at DEBUG/INFO, chatty libraries one tier quieter."""
    root_level = logging.DEBUG if (verbose or debug) else logging.INFO
    chatty_level = logging.INFO if (verbose or debug) else logging.WARNING
    logging.getLogger().setLevel(root_level)
    for name in CHATTY_LOGGERS:
        logging.getLogger(name).setLevel(chatty_level)
