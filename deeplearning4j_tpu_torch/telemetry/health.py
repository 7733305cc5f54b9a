"""Training health monitor (counterpart of
deeplearning4j_tpu/telemetry/health.py): the stall watchdog, straggler
skew and input-pipeline accounting, under the JAX package's metric names
and gates.

  stall watchdog      every fit path heartbeats the process-global
                      HealthMonitor after each step (a monotonic
                      perf_counter stamp). A daemon watchdog thread fires
                      when a fit is active but no step completed within
                      ``DL4J_TPU_STALL_TIMEOUT`` seconds: one
                      ``dl4j_tpu_stall_detected_total{phase}`` increment,
                      a "stall" instant event, one warnings.warn, and a
                      flight-recorder bundle (telemetry/flight.py).
  straggler skew      ``observe_worker_skew`` publishes per-lane duration /
                      median as ``dl4j_tpu_straggler_skew_ratio{device}``
                      and warns past ``DL4J_TPU_STRAGGLER_RATIO``;
                      ``ingest_event_stats`` feeds it from per-worker
                      event records.
  input pipeline      AsyncDataSetIterator reports prefetch queue depth and
                      producer/consumer wait seconds; ``input_verdict()``
                      combines them with the etl/step span medians into an
                      input-bound vs compute-bound verdict.

With ``DL4J_TPU_TELEMETRY`` off, ``fit_health()`` returns the shared
``NULL_HEALTH``, ``live()`` returns None, and no monitor or watchdog
thread is created. ``/healthz`` (ui/server.py) serves 503 until the first
heartbeat and the ``healthz()`` snapshot after.
"""
from __future__ import annotations

import statistics
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util import envflags

STALL_GATE = "DL4J_TPU_STALL_TIMEOUT"
STRAGGLER_GATE = "DL4J_TPU_STRAGGLER_RATIO"

DEFAULT_STALL_TIMEOUT_S = 300.0
DEFAULT_STRAGGLER_RATIO = 2.0

# registered at import like the JAX module's, so both packages' registries
# hold the same families (help text included) once imported
_STALLS = metrics_mod.counter(
    "dl4j_tpu_stall_detected_total",
    "Stall-watchdog trips: a fit was active but no step completed within "
    "DL4J_TPU_STALL_TIMEOUT", labelnames=("phase",))
_SKEW = metrics_mod.gauge(
    "dl4j_tpu_straggler_skew_ratio",
    "Per-device/worker step-time skew: lane duration / median over the "
    "last observation window", labelnames=("device",))
_QUEUE_DEPTH = metrics_mod.gauge(
    "dl4j_tpu_prefetch_queue_depth",
    "Prefetch queue depth sampled at the last consumer fetch")
_CONSUMER_WAIT = metrics_mod.counter(
    "dl4j_tpu_prefetch_consumer_wait_seconds_total",
    "Seconds the training loop spent blocked on an empty prefetch queue "
    "(input-bound signal)")
_PRODUCER_WAIT = metrics_mod.counter(
    "dl4j_tpu_prefetch_producer_wait_seconds_total",
    "Seconds prefetch producer threads spent blocked on a full queue "
    "(compute-bound signal)")
# elastic-membership telemetry: the transition counter stays live with the
# span gate off (the cold-path policy every resilience counter follows), so
# a chaos run's metrics always show the exact recovery arc; the instant
# event rides the tracer gate
_MEMBERSHIP = metrics_mod.counter(
    "dl4j_tpu_membership_transitions_total",
    "Elastic-membership state transitions (join, suspect, evict_host_loss,"
    " evict_heartbeat, evict_straggler, evict_exception, rejoin,"
    " rejoin_failed)", labelnames=("event",))
_MEMBERS = metrics_mod.gauge(
    "dl4j_tpu_membership_active_workers",
    "Workers currently ACTIVE in the elastic membership registry")
_GENERATION = metrics_mod.gauge(
    "dl4j_tpu_membership_generation",
    "Membership generation number (bumps on every join/evict/rejoin)")


def stall_timeout_s() -> float:
    return envflags.float_value(STALL_GATE, DEFAULT_STALL_TIMEOUT_S)


def straggler_ratio() -> float:
    return envflags.float_value(STRAGGLER_GATE, DEFAULT_STRAGGLER_RATIO)


def observe_membership_transition(event: str, worker=None,
                                  generation: int = 0,
                                  active: int = 0,
                                  reason: str = "") -> None:
    """One elastic-membership transition (distributed/membership.py):
    counter tick unconditionally (cold path — the recovery arc must be
    countable even with spans off), gauges for the live view, and a
    "membership" instant event on the trace timeline when the tracer is
    enabled."""
    _MEMBERSHIP.labels(event).inc()
    _MEMBERS.set(active)
    _GENERATION.set(generation)
    tr = trace_mod.tracer()
    if tr.enabled:
        tr.add_instant("membership", category="health", event=event,
                       worker=str(worker), generation=generation,
                       active=active, **({"reason": reason} if reason
                                         else {}))


class _NullHealth:
    """Disabled-path singleton (the NULL_SPAN pattern): every fit-loop
    hook is a no-op and nothing is allocated per call."""

    __slots__ = ()

    def beat(self, iteration: int = 0):
        pass

    def end(self):
        pass


NULL_HEALTH = _NullHealth()


class HealthMonitor:
    """Process-global liveness/skew/pipeline state. Created lazily by the
    first telemetry-enabled fit (``fit_health``); the watchdog daemon
    thread starts on the first heartbeat and then idles between checks
    (interval = clamp(timeout/4, 50 ms, 2 s); heartbeats wake it early so
    a re-tuned DL4J_TPU_STALL_TIMEOUT takes effect immediately)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._beat_perf: Optional[float] = None  # guarded-by: self._lock
        self._phase: str = ""  # guarded-by: self._lock
        self._iteration: int = 0  # guarded-by: self._lock
        self._active_fits: int = 0  # guarded-by: self._lock
        self._stalled = False  # guarded-by: self._lock
        self._stall_count = 0  # guarded-by: self._lock
        self._last_stall_bundle: Optional[str] = None  # guarded-by: self._lock
        self.depths: deque = deque(maxlen=512)
        self._skew_report: Dict[str, float] = {}  # guarded-by: self._lock
        self._warned_stragglers: set = set()  # guarded-by: self._lock
        self._wake = threading.Event()
        self._watchdog: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # heartbeat / fit lifecycle
    # ------------------------------------------------------------------
    def fit_begin(self, phase: str) -> None:
        with self._lock:
            self._active_fits += 1
            self._phase = phase
            self._beat_perf = time.perf_counter()
        self._ensure_watchdog()
        # wake the watchdog at fit EDGES only (it re-reads the timeout
        # gate and re-arms its interval); per-step beats stay a lock +
        # three assignments — no cross-thread wakeup on the hot path
        self._wake.set()

    def beat(self, phase: str, iteration: int) -> None:
        with self._lock:
            self._beat_perf = time.perf_counter()
            self._phase = phase
            self._iteration = int(iteration)
            self._stalled = False  # a completed step ends the episode

    def fit_end(self) -> None:
        with self._lock:
            self._active_fits = max(0, self._active_fits - 1)

    # ------------------------------------------------------------------
    # input-pipeline accounting (AsyncDataSetIterator hooks)
    # ------------------------------------------------------------------
    def record_consumer(self, depth: int, wait_s: float) -> None:
        self.depths.append(int(depth))
        _QUEUE_DEPTH.set(depth)
        if wait_s > 0:
            _CONSUMER_WAIT.inc(wait_s)

    def record_producer_wait(self, wait_s: float) -> None:
        if wait_s > 0:
            _PRODUCER_WAIT.inc(wait_s)

    # ------------------------------------------------------------------
    # straggler detection
    # ------------------------------------------------------------------
    def observe_worker_skew(self, durations: Dict[str, float]) -> Dict[str, float]:
        """One observation window of per-lane durations (seconds): publish
        duration/median as ``dl4j_tpu_straggler_skew_ratio{device}`` and
        warn (once per lane) + emit a "straggler" instant event for lanes
        past DL4J_TPU_STRAGGLER_RATIO. Returns {lane: ratio}."""
        durs = {k: float(v) for k, v in durations.items() if v is not None}
        if not durs:
            return {}
        median = statistics.median(durs.values())
        if median <= 0:
            return {}
        threshold = straggler_ratio()
        report = {}
        for lane, d in sorted(durs.items()):
            ratio = d / median
            report[lane] = round(ratio, 3)
            _SKEW.labels(lane).set(report[lane])
            if len(durs) > 1 and ratio > threshold:
                trace_mod.tracer().add_instant(
                    "straggler", category="health", device=lane,
                    ratio=report[lane], median_s=round(median, 4))
                with self._lock:
                    first_sighting = lane not in self._warned_stragglers
                    self._warned_stragglers.add(lane)
                if first_sighting:
                    warnings.warn(
                        f"straggler detected: {lane} ran {ratio:.2f}x the "
                        f"median lane time (threshold {threshold}; "
                        f"DL4J_TPU_STRAGGLER_RATIO) — docs/HEALTH.md",
                        stacklevel=2)
        with self._lock:
            self._skew_report = report
        return report

    def ingest_event_stats(self, events) -> Dict[str, float]:
        """Straggler pass over distributed/stats.py EventStats (objects or
        dicts): total per-worker duration of worker-attributed events →
        observe_worker_skew. Master/driver events (worker=None) are
        orchestration, not lanes — skipped."""
        per_worker: Dict[str, float] = {}
        for e in events:
            worker = e.get("worker") if isinstance(e, dict) else e.worker
            dur = (e.get("duration_ms") if isinstance(e, dict)
                   else e.duration_ms)
            if worker is None or dur is None:
                continue
            lane = f"worker {worker}"
            per_worker[lane] = per_worker.get(lane, 0.0) + float(dur) / 1e3
        if len(per_worker) < 2:
            return {}
        return self.observe_worker_skew(per_worker)

    # ------------------------------------------------------------------
    # watchdog
    # ------------------------------------------------------------------
    def _ensure_watchdog(self) -> None:
        with self._lock:
            if self._watchdog is not None:
                return
            t = threading.Thread(target=self._watch, daemon=True,
                                 name="dl4j-tpu-health-watchdog")
            self._watchdog = t
        t.start()

    def _watch(self) -> None:
        while True:
            timeout = stall_timeout_s()
            interval = min(max(timeout / 4.0, 0.05), 2.0) if timeout > 0 \
                else 2.0
            self._wake.wait(interval)
            self._wake.clear()
            if timeout <= 0:
                continue
            with self._lock:
                active = self._active_fits
                beat = self._beat_perf
                phase = self._phase
                iteration = self._iteration
                already = self._stalled
            if not active or beat is None or already:
                continue
            age = time.perf_counter() - beat
            if age < timeout:
                continue
            with self._lock:
                self._stalled = True
                self._stall_count += 1
            self._report_stall(phase, iteration, age, timeout)

    def _report_stall(self, phase: str, iteration: int, age: float,
                      timeout: float) -> None:
        trace_mod.tracer().add_instant(
            "stall", category="health", phase=phase, iteration=iteration,
            age_s=round(age, 3), timeout_s=timeout)
        warnings.warn(
            f"training stall: no step completed in {phase or '?'} for "
            f"{age:.1f}s (> DL4J_TPU_STALL_TIMEOUT={timeout:g}s) at "
            f"iteration {iteration} — hung collective / dead input "
            f"pipeline? A flight-recorder bundle is being written "
            f"(docs/HEALTH.md)", stacklevel=2)
        try:
            from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

            # Write the bundle OUTSIDE the lock (it serializes to disk),
            # then publish the path under it for snapshot() readers.
            bundle = flight_mod.dump(
                "stall", note=f"no step for {age:.1f}s in {phase or '?'} "
                              f"at iteration {iteration}")
        except Exception:  # the watchdog must never take down training
            bundle = None
        with self._lock:
            self._last_stall_bundle = bundle
        # The counter ticks LAST: it is the observable "stall reported"
        # signal pollers key on, so everything the episode promises —
        # trace instant, flight bundle, published path — must already be
        # in place when it moves.
        _STALLS.labels(phase or "?").inc()

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            beat = self._beat_perf
            out = {
                "ok": not self._stalled,
                "phase": self._phase or None,
                "iteration": self._iteration,
                "active_fits": self._active_fits,
                "stalled": self._stalled,
                "stalls": self._stall_count,
                "stall_timeout_s": stall_timeout_s(),
                "last_step_age_s": (None if beat is None else
                                    round(time.perf_counter() - beat, 3)),
                "stragglers": dict(self._skew_report),
                "last_stall_bundle": self._last_stall_bundle,
            }
        out["input_pipeline"] = input_verdict()
        return out


# ---------------------------------------------------------------------------
# process-global plumbing
# ---------------------------------------------------------------------------

_monitor: Optional[HealthMonitor] = None
_monitor_lock = threading.Lock()


def monitor() -> HealthMonitor:
    """The process-global HealthMonitor (created on first use; the
    watchdog thread only starts once a fit heartbeats)."""
    global _monitor
    m = _monitor
    if m is None:
        with _monitor_lock:
            m = _monitor
            if m is None:
                m = _monitor = HealthMonitor()
    return m


def live() -> Optional[HealthMonitor]:
    """The monitor when telemetry is enabled, else None — the one check
    hot paths (prefetch threads, masters) make before recording."""
    if not trace_mod.tracer().enabled:
        return None
    return monitor()


class _FitHealth:
    """Per-fit heartbeat handle returned by ``fit_health`` when the gate
    is on; ``beat`` stamps each completed step, ``end`` closes the fit."""

    __slots__ = ("_m", "_phase")

    def __init__(self, m: HealthMonitor, phase: str):
        self._m = m
        self._phase = phase
        m.fit_begin(phase)

    def beat(self, iteration: int = 0):
        self._m.beat(self._phase, iteration)

    def end(self):
        self._m.fit_end()


def fit_health(phase: str):
    """Entry point for the fit loops: a live heartbeat handle when
    DL4J_TPU_TELEMETRY is on, else the shared no-op (zero allocation).
    Also installs the faulthandler fatal-signal dump on first use
    (telemetry/flight.py) so even a SIGABRT leaves a stack artifact."""
    if not trace_mod.tracer().enabled:
        return NULL_HEALTH
    from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

    flight_mod.install_faulthandler()
    return _FitHealth(monitor(), phase)


def healthz() -> Dict[str, Any]:
    """The ``/healthz`` payload: {"ok": False, reason} until the first
    heartbeat (the server maps ok=False to 503), the monitor snapshot
    after. Never creates the monitor or its watchdog thread."""
    m = _monitor
    if m is None or m._beat_perf is None:
        return {"ok": False, "reason": "no heartbeat yet (no telemetry-"
                                       "enabled fit has completed a step)"}
    return m.snapshot()


def input_verdict(records=None) -> Dict[str, Any]:
    """Input-bound vs compute-bound verdict from the etl/step span medians
    plus the prefetch queue counters:

      input_bound    etl p50 exceeds step p50 — the accelerator waits on
                     the host pipeline more than it computes
      balanced       etl p50 is over a quarter of step p50
      compute_bound  etl is noise next to the step
      unknown        no etl+step spans recorded (telemetry off, or no fit)

    Pass ``records`` (SpanRecord list) to scope the verdict to one window
    (bench.py does, per config); default is the whole ring buffer."""
    recs = trace_mod.tracer().records() if records is None else records
    etl = [r.duration_ms for r in recs if r.phase == "X" and r.name == "etl"]
    step = [r.duration_ms for r in recs
            if r.phase == "X" and r.name == "step"]
    m = _monitor
    out: Dict[str, Any] = {
        "verdict": "unknown",
        "etl_p50_ms": None,
        "step_p50_ms": None,
        "queue_depth_p50": (round(statistics.median(m.depths), 1)
                            if m is not None and m.depths else None),
        "consumer_wait_seconds": round(_CONSUMER_WAIT.value, 4),
        "producer_wait_seconds": round(_PRODUCER_WAIT.value, 4),
    }
    if not etl or not step:
        return out
    e, s = statistics.median(etl), statistics.median(step)
    out["etl_p50_ms"] = round(e, 3)
    out["step_p50_ms"] = round(s, 3)
    if e > s:
        out["verdict"] = "input_bound"
    elif e > 0.25 * s:
        out["verdict"] = "balanced"
    else:
        out["verdict"] = "compute_bound"
    return out


def reset_for_tests() -> None:
    """Zero the monitor's liveness/skew/pipeline state (the watchdog
    thread, once started, is reused — daemon threads can't be joined
    away)."""
    m = _monitor
    if m is None:
        return
    with m._lock:
        m._beat_perf = None
        m._phase = ""
        m._iteration = 0
        m._active_fits = 0
        m._stalled = False
        m._stall_count = 0
        m._last_stall_bundle = None
        m.depths.clear()
        m._skew_report = {}
        m._warned_stragglers.clear()
