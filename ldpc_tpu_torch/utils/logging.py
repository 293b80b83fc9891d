"""Structured logging (counterpart of ``ldpc_tpu.utils.logging``).

A standard ``logging`` logger on stderr, its level from
``LDPC_TPU_LOG_LEVEL`` (default INFO), and an opt-in flag for per-stage
tensor dumps, ``LDPC_TPU_DEBUG_DUMPS=1``.  The environment variables are the
JAX package's, so one setting governs both packages.
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "ldpc_tpu_torch", level: str | int | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    if level is None:
        level = os.environ.get("LDPC_TPU_LOG_LEVEL", "INFO")
    logger.setLevel(level)
    return logger


def debug_dumps_enabled() -> bool:
    """Per-stage tensor dumps (shapes and ranges), behind LDPC_TPU_DEBUG_DUMPS=1."""
    return os.environ.get("LDPC_TPU_DEBUG_DUMPS", "0") == "1"
