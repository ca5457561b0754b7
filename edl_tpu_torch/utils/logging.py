"""Uniform logger factory (copy of ``edl_tpu.utils.logging``)."""

from __future__ import annotations

import logging
import sys

from edl_tpu_torch.utils import config

_FORMAT = "%(asctime)s %(levelname)s %(name)s [%(process)d] %(message)s"

_configured: set[str] = set()


def get_logger(name: str, level: int | str | None = None) -> logging.Logger:
    """Return a logger with the framework-wide format, configured once."""
    logger = logging.getLogger(name)
    if name not in _configured:
        _configured.add(name)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
        if level is None:
            level = config.env_str("EDL_TPU_LOG_LEVEL", "INFO")
        logger.setLevel(level)
    return logger
