"""Structured logging (the logger/logger.go analog).

Auto-quiets under pytest like the reference quiets under `go test`
(logger/logger.go:24); Set/disable API mirrors logger.Set/Disable.
"""

from __future__ import annotations

import logging
import sys
import time


logger = logging.getLogger("gnark_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).3s gnark_tpu_torch %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING if "pytest" in sys.modules else logging.INFO)


def set_level(level):
    logger.setLevel(level)


def disable():
    logger.setLevel(logging.CRITICAL + 1)


class timed:
    """Context manager: logs `<what> took <ms>` like the reference's
    duration logs (internal/backend/bn254/groth16/prove.go:270)."""

    def __init__(self, what, **fields):
        self.what = what
        self.fields = fields

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1e3
        extra = " ".join(f"{k}={v}" for k, v in self.fields.items())
        logger.info("%s took %.1fms %s", self.what, ms, extra)
        return False
