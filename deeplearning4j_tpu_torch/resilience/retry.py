"""Retry with backoff, and a deadline, for flaky IO (the port's copy of
deeplearning4j_tpu/resilience/retry.py):

    DL4J_TPU_RETRY_ATTEMPTS   default attempt count when a call site
                              passes attempts=None (default 3)
    DL4J_TPU_RETRY_BACKOFF    default first-retry sleep in seconds when a
                              call site passes backoff=None (default 0.05)
    DL4J_TPU_RETRY_JITTER     default jitter weight in [0, 1] when a call
                              site passes jitter=None (default 0: the
                              deterministic schedule)

Backoff is exponential (backoff * 2**retry_index) capped at `max_backoff`;
a non-zero jitter weight blends it toward decorrelated jitter
(`min(cap, uniform(base, 3 * previous_delay))`), so workers that failed
together do not retry in lockstep. The jitter generator is process-local
and seedable (`seed_jitter`). Every failed attempt ticks
``dl4j_tpu_retry_attempts_total{error}`` and a call that gives up ticks
``dl4j_tpu_retry_exhausted_total``, under the JAX package's names.

    dl = Deadline(30.0)
    while ...:
        dl.check("checkpoint upload")   # raises TimeoutError when spent
        step(timeout=dl.remaining())
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.util import envflags

_ATTEMPTS_GATE = "DL4J_TPU_RETRY_ATTEMPTS"
_BACKOFF_GATE = "DL4J_TPU_RETRY_BACKOFF"
_JITTER_GATE = "DL4J_TPU_RETRY_JITTER"

# process-local jitter source: decorrelation needs randomness, tests need
# reproducibility — seed_jitter() gives chaos arcs a deterministic replay
_jitter_rng = random.Random()


def seed_jitter(seed: Optional[int]) -> None:
    """Seed the module's jitter RNG (None reseeds from OS entropy)."""
    _jitter_rng.seed(seed)


# failure-path telemetry: one tick per failed attempt, nothing on the
# happy path
_RETRY_ATTEMPTS = metrics_mod.counter(
    "dl4j_tpu_retry_attempts_total",
    "Failed attempts that were (or would have been) retried, by error type",
    labelnames=("error",))
_RETRY_EXHAUSTED = metrics_mod.counter(
    "dl4j_tpu_retry_exhausted_total",
    "retry_call invocations that raised after exhausting every attempt")


class Deadline:
    """Wall-clock budget shared across a multi-step operation.

        dl = Deadline(30.0)
        while ...:
            dl.check("checkpoint upload")   # raises TimeoutError when spent
            step(timeout=dl.remaining())
    """

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


def _resolve_attempts(attempts: Optional[int]) -> int:
    if attempts is not None:
        return max(1, int(attempts))
    return max(1, envflags.int_value(_ATTEMPTS_GATE, 3))


def _resolve_backoff(backoff: Optional[float]) -> float:
    if backoff is not None:
        return float(backoff)
    return envflags.float_value(_BACKOFF_GATE, 0.05)


def _resolve_jitter(jitter: Optional[float]) -> float:
    if jitter is not None:
        return min(1.0, max(0.0, float(jitter)))
    return min(1.0, max(0.0, envflags.float_value(_JITTER_GATE, 0.0)))


def decorrelated_backoff(previous: float, base: float,
                         cap: float = 5.0,
                         rng: Optional[random.Random] = None) -> float:
    """One step of decorrelated-jitter backoff:
    ``min(cap, uniform(base, 3 * previous))``. `previous` is the last
    delay actually slept (pass `base` for the first step). Unlike
    exponential backoff this never synchronizes: two workers that failed
    at the same instant draw independent delays whose spread GROWS with
    the retry count, so a mass rejoin fans out instead of stampeding."""
    rng = _jitter_rng if rng is None else rng
    base = max(0.0, float(base))
    hi = max(base, 3.0 * max(base, float(previous)))
    return min(float(cap), rng.uniform(base, hi))


def retry_call(
    fn: Callable,
    *args,
    attempts: Optional[int] = None,
    backoff: Optional[float] = None,
    max_backoff: float = 5.0,
    jitter: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    deadline: Optional[Deadline] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """Call `fn(*args, **kwargs)`, retrying on `retry_on` exceptions.

    attempts/backoff/jitter fall back to the DL4J_TPU_RETRY_* gates when
    None. `jitter` in [0, 1] blends the deterministic exponential
    schedule toward decorrelated jitter (0 = deterministic, the
    historical default; 1 = fully decorrelated) — see
    `decorrelated_backoff`. A Deadline bounds the WHOLE operation: once
    spent, the last error is re-raised instead of sleeping again.
    `on_retry(retry_index, exc)` is a telemetry hook fired before each
    backoff sleep."""
    n = _resolve_attempts(attempts)
    b = _resolve_backoff(backoff)
    j = _resolve_jitter(jitter)
    prev_delay = b
    last: Optional[BaseException] = None
    for i in range(n):
        if deadline is not None and deadline.expired and last is not None:
            raise last
        try:
            return fn(*args, **kwargs)
        except retry_on as e:  # noqa: PERF203 — retry loops try per attempt
            last = e
            _RETRY_ATTEMPTS.labels(type(e).__name__).inc()
            if i == n - 1:
                _RETRY_EXHAUSTED.inc()
                raise
            if on_retry is not None:
                on_retry(i, e)
            delay = min(b * (2 ** i), max_backoff)
            if j:
                decorr = decorrelated_backoff(prev_delay, b, max_backoff)
                delay = (1.0 - j) * delay + j * decorr
            prev_delay = delay
            if deadline is not None:
                if deadline.expired:
                    raise
                delay = min(delay, max(0.0, deadline.remaining()))
            if delay > 0:
                sleep(delay)
    raise last  # unreachable: loop either returns or raises


def retry(
    attempts: Optional[int] = None,
    backoff: Optional[float] = None,
    max_backoff: float = 5.0,
    jitter: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    deadline_seconds: Optional[float] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Decorator form of retry_call.

        @retry(attempts=5, backoff=0.1, retry_on=(IOError,))
        def download(...): ...

    attempts=None / backoff=None read the DL4J_TPU_RETRY_* gates at CALL
    time, so an operator can tune retry posture without code changes.
    `deadline_seconds` starts a fresh Deadline per call."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            dl = (Deadline(deadline_seconds)
                  if deadline_seconds is not None else None)
            return retry_call(
                fn, *args, attempts=attempts, backoff=backoff,
                max_backoff=max_backoff, jitter=jitter, retry_on=retry_on,
                deadline=dl, sleep=sleep, on_retry=on_retry, **kwargs)

        return wrapper

    return deco
