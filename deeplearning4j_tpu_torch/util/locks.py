"""Runtime lock-order sentinel (counterpart of
deeplearning4j_tpu/util/locks.py).

`TrackedLock` / `TrackedRLock` are drop-in replacements for
`threading.Lock` / `threading.RLock` that watch the lock orders that
actually happen at runtime:

    self._lock = TrackedRLock("serving.registry")

Gated by `DL4J_TPU_LOCKCHECK` (util/envflags.py spellings). When the gate
is OFF — the default — the constructor returns a RAW `threading.Lock()` /
`threading.RLock()`: no wrapper object, no tracker, no per-acquire
bookkeeping. When ON, each first acquisition records the (held ->
acquired) site pair in a process-global order graph; an acquisition that
reverses an already-observed pair is a lock-order INVERSION (the
two-thread interleaving of those stacks deadlocks), and the sentinel:

  * ticks `dl4j_tpu_lock_inversions_total{site}`,
  * writes ONE flight bundle per inverted pair (reason `lock_inversion`,
    both stack tops, so the postmortem shows each side of the would-be
    deadlock; telemetry/flight.py, gated by `DL4J_TPU_TELEMETRY`),
  * records the event for `inversions()`.

It also measures hold times: releasing a lock held longer than
`DL4J_TPU_LOCKCHECK_HOLD_S` (default 1.0 s) ticks
`dl4j_tpu_lock_long_holds_total{site}`.

Both wrappers are `threading.Condition`-compatible: TrackedLock via the
Condition's release()/acquire() fallback, TrackedRLock via the
`_release_save`/`_acquire_restore`/`_is_owned` protocol (so a
`cond.wait()` drops the held-stack entry while waiting).
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.util import envflags

LOCKCHECK_GATE = "DL4J_TPU_LOCKCHECK"
HOLD_GATE = "DL4J_TPU_LOCKCHECK_HOLD_S"

_tracker: Optional["_Tracker"] = None
_tracker_lock = threading.Lock()


def lockcheck_enabled() -> bool:
    return envflags.enabled(LOCKCHECK_GATE)


def _stack_top(skip: int = 3, depth: int = 5) -> List[str]:
    """A short formatted stack summary ending at the acquire site."""
    frames = traceback.extract_stack()[:-skip][-depth:]
    return [f"{f.filename}:{f.lineno} in {f.name}" for f in frames]


class _Tracker:
    """Process-global acquisition-order graph, built only when the gate
    is on."""

    def __init__(self) -> None:
        from deeplearning4j_tpu_torch.telemetry import metrics

        self._mu = threading.Lock()
        # (first_site, second_site) -> stack of the first observation
        self._edges: Dict[Tuple[str, str], List[str]] = {}  # guarded-by: self._mu
        self._events: List[dict] = []  # guarded-by: self._mu
        self._reported: set = set()  # guarded-by: self._mu
        self._tls = threading.local()
        self.hold_threshold_s = envflags.float_value(HOLD_GATE, 1.0)
        self._inversions = metrics.counter(
            "dl4j_tpu_lock_inversions_total",
            "runtime lock-order inversions detected by TrackedLock",
            ("site",))
        self._long_holds = metrics.counter(
            "dl4j_tpu_lock_long_holds_total",
            "lock holds exceeding DL4J_TPU_LOCKCHECK_HOLD_S",
            ("site",))

    def _held(self) -> List[dict]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def on_acquired(self, site: str) -> None:
        held = self._held()
        stack = _stack_top()
        inverted: Optional[Tuple[str, List[str]]] = None
        with self._mu:
            for entry in held:
                pair = (entry["site"], site)
                rev = (site, entry["site"])
                if rev in self._edges and pair not in self._edges:
                    self._inversions.labels(site).inc()
                    self._events.append({
                        "site": site,
                        "against": entry["site"],
                        "stack": stack,
                        "first_stack": self._edges[rev],
                    })
                    key = frozenset(pair)
                    if key not in self._reported:
                        self._reported.add(key)
                        inverted = (entry["site"], self._edges[rev])
                self._edges.setdefault(pair, stack)
        held.append({"site": site, "stack": stack,
                     "t0": time.perf_counter()})
        if inverted is not None:
            self._bundle(site, stack, inverted[0], inverted[1])

    def on_released(self, site: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i]["site"] == site:
                entry = held.pop(i)
                if time.perf_counter() - entry["t0"] > self.hold_threshold_s:
                    self._long_holds.labels(site).inc()
                return

    def _bundle(self, site: str, stack: List[str],
                other_site: str, other_stack: List[str]) -> None:
        """First detection of an inverted pair: a flight bundle with BOTH
        stack tops (no-op when telemetry is off; dump never raises)."""
        from deeplearning4j_tpu_torch.telemetry import flight

        flight.dump(
            "lock_inversion",
            note=f"lock-order inversion: {site} acquired while holding "
                 f"{other_site}, but the opposite order was observed "
                 f"earlier — the two-thread interleaving deadlocks",
            extra={"lock_inversion": {
                "site": site,
                "held_site": other_site,
                "acquire_stack": stack,
                "first_observed_stack": other_stack,
            }})

    def events(self) -> List[dict]:
        with self._mu:
            return list(self._events)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._events.clear()
            self._reported.clear()


def tracker() -> "_Tracker":
    """The process-global tracker (created on first use, gate on)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = _Tracker()
        return _tracker


def inversions() -> List[dict]:
    """Inversion events observed so far ([] when the gate is off)."""
    if _tracker is None:
        return []
    return _tracker.events()


def reset_for_tests() -> None:
    if _tracker is not None:
        _tracker.reset()


class TrackedLock:
    """`threading.Lock` that reports order inversions and long holds.
    With `DL4J_TPU_LOCKCHECK` off, __new__ returns a RAW threading.Lock
    (no wrapper is allocated and __init__ never runs)."""

    def __new__(cls, site: str = "lock"):
        if not lockcheck_enabled():
            return threading.Lock()
        return super().__new__(cls)

    def __init__(self, site: str = "lock"):
        self.site = site
        self._inner = threading.Lock()
        self._tracker = tracker()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._tracker.on_acquired(self.site)
        return got

    def release(self) -> None:
        self._tracker.on_released(self.site)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.site} {self._inner!r}>"


class TrackedRLock:
    """`threading.RLock` twin of TrackedLock: order tracking happens on
    the 0->1 transition only (re-entries are order-neutral)."""

    def __new__(cls, site: str = "rlock"):
        if not lockcheck_enabled():
            return threading.RLock()
        return super().__new__(cls)

    def __init__(self, site: str = "rlock"):
        self.site = site
        self._inner = threading.RLock()
        self._tracker = tracker()
        self._local = threading.local()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = self._depth()
            self._local.depth = d + 1
            if d == 0:
                self._tracker.on_acquired(self.site)
        return got

    def release(self) -> None:
        d = self._depth()
        if d == 1:
            self._tracker.on_released(self.site)
        self._local.depth = max(0, d - 1)
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # ---- threading.Condition protocol ----
    def _release_save(self):
        d = self._depth()
        self._local.depth = 0
        self._tracker.on_released(self.site)
        for _ in range(d):
            self._inner.release()
        return d

    def _acquire_restore(self, state: int) -> None:
        for _ in range(state):
            self._inner.acquire()
        self._local.depth = state
        self._tracker.on_acquired(self.site)

    def _is_owned(self) -> bool:
        return self._depth() > 0

    def __repr__(self) -> str:
        return f"<TrackedRLock {self.site} depth={self._depth()}>"
