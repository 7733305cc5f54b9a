"""CircuitBreaker — stop dispatching into a broken model/device path (the
port's own copy of deeplearning4j_tpu/serving/breaker.py).

When dispatches fail back to back (device wedged, model produces NaN,
chaos says so), continuing to admit requests just converts every
caller's latency budget into a guaranteed error after a full queue wait.
The breaker converts that into a FAST typed rejection (CircuitOpenError
at admission, with a retry-after hint) while probing for recovery:

    CLOSED     normal operation. `failure_threshold` CONSECUTIVE
               failures (any success resets the streak) trips it OPEN.
    OPEN       every request rejected at admission for `cooldown_s`,
               after which the next admission attempt transitions to
               HALF_OPEN and becomes a probe.
    HALF_OPEN  up to `max_probes` requests in flight at a time; any
               failure re-opens (fresh cooldown), `probe_successes`
               consecutive successes close the breaker.

Every transition ticks
``dl4j_tpu_serving_breaker_transitions_total{state}`` with the state
ENTERED — a recovery arc open -> half_open -> closed is three exact
counter increments. `on_open` is the flight-recorder hook
(serving/runtime.py dumps a breaker-open bundle there).

Thread-safe: admission and dispatch results arrive from different
threads. The injected `clock` (monotonic) keeps cooldown tests exact.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_TRANSITIONS = metrics_mod.counter(
    "dl4j_tpu_serving_breaker_transitions_total",
    "Circuit-breaker transitions, labeled by the state entered",
    labelnames=("state",))

class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 1.0,
                 probe_successes: int = 2, max_probes: int = 1,
                 on_open: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.probe_successes = max(1, int(probe_successes))
        self.max_probes = max(1, int(max_probes))
        self.on_open = on_open
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: self._lock
        self._consecutive_failures = 0  # guarded-by: self._lock
        self._probe_streak = 0  # guarded-by: self._lock
        self._probes_in_flight = 0  # guarded-by: self._lock
        self._opened_at: Optional[float] = None  # guarded-by: self._lock
        self._last_reason = ""  # guarded-by: self._lock

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until the next half-open probe window (0 when not
        open) — the hint CircuitOpenError carries back to callers."""
        with self._lock:
            if self._state != OPEN or self._opened_at is None:
                return 0.0
            return max(0.0, self.cooldown_s
                       - (self._clock() - self._opened_at))

    def _transition(self, state: str) -> None:
        # lock held by caller
        self._state = state
        _TRANSITIONS.labels(state).inc()

    # ------------------------------------------------------------------
    def admit(self) -> Tuple[bool, bool]:
        """Admission decision as ``(allowed, holds_probe_slot)``. OPEN
        past its cooldown flips to HALF_OPEN and admits the caller as a
        probe; HALF_OPEN admits at most `max_probes` in flight. When
        `holds_probe_slot` is True the caller OWES the slot back: a
        dispatch result (record_success/record_failure) repays it, and
        a request resolved WITHOUT a dispatch (queue expiry, drop,
        drain) must call release_probe() or the breaker wedges in
        HALF_OPEN rejecting everything forever."""
        with self._lock:
            if self._state == CLOSED:
                return True, False
            if self._state == OPEN:
                if (self._opened_at is not None
                        and self._clock() - self._opened_at
                        >= self.cooldown_s):
                    self._transition(HALF_OPEN)
                    self._probe_streak = 0
                    self._probes_in_flight = 1
                    return True, True
                return False, False
            # HALF_OPEN
            if self._probes_in_flight >= self.max_probes:
                return False, False
            self._probes_in_flight += 1
            return True, True

    def allow_request(self) -> bool:
        """Bool form of `admit` for callers that track slots themselves
        (or never resolve without a dispatch result)."""
        return self.admit()[0]

    def release_probe(self) -> None:
        """Un-take a half-open probe slot when admission later refuses
        the request for a different reason (deadline, full queue): the
        slot must go back or the breaker would wait forever for a probe
        result that will never arrive."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._probe_streak += 1
                if self._probe_streak >= self.probe_successes:
                    self._transition(CLOSED)

    def record_failure(self, reason: str = "dispatch failure") -> bool:
        """Returns True when THIS failure opened (or re-opened) the
        breaker — the runtime writes its flight bundle on that edge, not
        on every failure inside an already-open episode."""
        opened = False
        with self._lock:
            self._last_reason = reason
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._transition(OPEN)
                self._opened_at = self._clock()
                self._consecutive_failures = 0
                opened = True
            elif self._state == CLOSED:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    self._transition(OPEN)
                    self._opened_at = self._clock()
                    self._consecutive_failures = 0
                    opened = True
            # already OPEN: a straggling in-flight failure changes nothing
        if opened and self.on_open is not None:
            try:
                self.on_open(reason)
            except Exception:  # the hook must never mask the failure arc
                import logging

                logging.getLogger("deeplearning4j_tpu_torch").exception(
                    "circuit-breaker on_open hook failed")
        return opened

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "retry_after_s": round(
                    max(0.0, self.cooldown_s
                        - (self._clock() - self._opened_at))
                    if self._state == OPEN and self._opened_at is not None
                    else 0.0, 4),
                "last_failure_reason": self._last_reason,
            }
