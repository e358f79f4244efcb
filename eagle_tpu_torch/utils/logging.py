"""Structured logging, opt-in via ``EAGLE_TPU_LOG`` (PyTorch counterpart
of ``eagle_tpu/utils/logging.py``): one JSON line an event on stderr at
INFO, ``{"ts", "event", ...fields}``."""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER = logging.getLogger("eagle_tpu_torch")
if not _LOGGER.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(message)s"))
    _LOGGER.addHandler(handler)
    _LOGGER.setLevel(os.environ.get("EAGLE_TPU_LOG", "WARNING").upper())
    _LOGGER.propagate = False


def get_logger() -> logging.Logger:
    return _LOGGER


def log_event(event: str, **fields) -> None:
    """One JSON line per event: {"ts", "event", ...fields}."""
    _LOGGER.info(json.dumps({"ts": round(time.time(), 3), "event": event, **fields}))
