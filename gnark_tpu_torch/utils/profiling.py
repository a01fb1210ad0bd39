"""Per-phase wall-clock profiling (counterpart of
gnark_tpu/utils/profiling.py).

The reference logs phase durations via zerolog ("took" fields,
internal/backend/bn254/groth16/prove.go:270, cs/r1cs.go:122); here a
context manager logs to the package logger, and `last_profile` keeps the
most recent run's numbers for programmatic inspection.  The provers'
phases (``backend/groth16.py::_Phases``, synchronised with the device)
land in `last_profile` too, as ``groth16.<phase>`` and ``plonk.<phase>``.
For the card's own timeline use torch.profiler traces.
"""

from __future__ import annotations

import contextlib
import time

from gnark_tpu_torch.utils.logging import logger

last_profile: dict = {}


@contextlib.contextmanager
def phase(name: str, sink: dict | None = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        (sink if sink is not None else last_profile)[name] = dt
        logger.info(f"{name} took {dt * 1000:.1f}ms")


def reset():
    last_profile.clear()
