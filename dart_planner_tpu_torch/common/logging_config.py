"""Structured logging setup (reference common/logging_config.py).

A framework-free copy of :mod:`dart_planner_tpu.common.logging_config`: the port keeps its own,
since the JAX package cannot be imported without jax."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

_CONFIGURED = False


class StructuredFormatter(logging.Formatter):
    """JSON-lines formatter for machine-readable logs."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": time.time(),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def setup_logging(
    level: str = "INFO",
    structured: bool = False,
    log_file: Optional[str] = None,
) -> None:
    """Idempotent root-logger configuration (reference logging_config.py)."""
    global _CONFIGURED
    root = logging.getLogger("dart_planner_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if _CONFIGURED:
        return
    handler: logging.Handler = (
        logging.FileHandler(log_file) if log_file else logging.StreamHandler(sys.stderr)
    )
    handler.setFormatter(
        StructuredFormatter()
        if structured
        else logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        )
    )
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """(reference get_logger)"""
    setup_logging()
    return logging.getLogger(f"dart_planner_tpu_torch.{name}")
