"""Deadline — a wall-clock budget shared across a multi-step operation (the
port's own copy of `Deadline` from deeplearning4j_tpu/resilience/retry.py;
retry/backoff comes with the distributed slice).

    dl = Deadline(30.0)
    while ...:
        dl.check("checkpoint upload")   # raises TimeoutError when spent
        step(timeout=dl.remaining())
"""
from __future__ import annotations

import time
from typing import Optional


class Deadline:
    """`seconds=None` never expires."""

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self._start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return self.seconds - self.elapsed()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise TimeoutError(
                f"{what} exceeded its {self.seconds:.3g}s deadline")
