"""Elastic membership — a generation-numbered worker registry
(counterpart of deeplearning4j_tpu/distributed/membership.py: the same
calls give the same snapshots in both packages).

Per-split heartbeats, failure detection that EVICTS a lost worker so its
owner can rebalance and continue degraded, straggler draining, and rejoin
through a coordinated checkpoint barrier. In the port the serving
Autoscaler keeps its replicas here (``auto_rejoin=False``); the JAX
package's distributed masters, which also run under it, are not ported
yet (ROADMAP A.11).

State machine:

    joining ──register──▶ active ──missed heartbeats──▶ suspect
                            │  ▲                          │
              exception /   │  │ heartbeat               evict
              straggler ────┤  │ (before eviction)        │
                            ▼  │                          ▼
       rejoining ◀─backoff── evicted ◀────────────────────┘
           │
           └──checkpoint barrier (rejoin fault point)──▶ active

Every transition bumps the registry `generation` and ticks
``dl4j_tpu_membership_transitions_total{event}`` (telemetry/health.py);
evictions for failures additionally write a flight-recorder bundle
(telemetry/flight.py) while the process still can, and the live worker
count / generation are exported as gauges.

Failure detectors, in order of specificity:

  exception      the owner observed the worker die — ``report_failure``
                 evicts immediately (reason ``host_loss`` for IO-shaped
                 errors — ChaosError is an IOError — else ``exception``).
  heartbeat      the worker is ALIVE BUT SILENT: no ``heartbeat()`` within
                 ``DL4J_TPU_HEARTBEAT_TIMEOUT`` seconds (default 60) of
                 monotonic clock. ``suspect_silent`` marks it suspect; a
                 beat rescues it, a second detection pass evicts it.
  straggler      the worker finishes its shards but runs
                 ``DL4J_TPU_EVICT_SKEW_RATIO``x past the median lane time
                 (0 = drain disabled) for ``DL4J_TPU_EVICT_SKEW_SPLITS``
                 consecutive splits (default 3). The worker is DRAINED:
                 evicted and not auto-rejoined (it would only straggle
                 again).

Rejoin: evicted-for-failure workers are auto-scheduled for rejoin with
DECORRELATED jittered backoff (resilience/retry.py; the base is
``DL4J_TPU_REJOIN_BACKOFF``). Admission happens only at a ``barrier()`` —
the coordinated checkpoint barrier an owner calls at each split boundary,
so every member agrees on the resume split through the checkpoint
manifest. The chaos ``rejoin`` fault point fires inside admission: a
failed first barrier backs the worker off and the next barrier admits it.

Multi-controller: transitions are queued as plain dict events
(``drain_pending_events``) for a coordinator to exchange and apply on
every process (``apply_remote_event``); the host stamp on each event is
the ``torch.distributed`` rank (telemetry/flight.py), None in a
single-process run.
"""
from __future__ import annotations

import enum
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.resilience.retry import decorrelated_backoff
from deeplearning4j_tpu_torch.telemetry import context as context_mod
from deeplearning4j_tpu_torch.telemetry import health as health_mod
from deeplearning4j_tpu_torch.util import envflags
from deeplearning4j_tpu_torch.util.locks import TrackedRLock

HEARTBEAT_GATE = "DL4J_TPU_HEARTBEAT_TIMEOUT"
EVICT_SKEW_RATIO_GATE = "DL4J_TPU_EVICT_SKEW_RATIO"
EVICT_SKEW_SPLITS_GATE = "DL4J_TPU_EVICT_SKEW_SPLITS"
REJOIN_BACKOFF_GATE = "DL4J_TPU_REJOIN_BACKOFF"

DEFAULT_HEARTBEAT_TIMEOUT_S = 60.0
DEFAULT_EVICT_SKEW_SPLITS = 3
DEFAULT_REJOIN_BACKOFF_S = 0.05
REJOIN_BACKOFF_CAP_S = 5.0

WorkerId = Union[int, str]


def _host_process_index():
    """Lazy host-id stamp (telemetry/flight.py's convention): the
    ``torch.distributed`` rank in a multi-process job, None in a single
    process. Guarded: a transition must never fail on the stamp."""
    try:
        from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

        return flight_mod.host_process_index()
    except Exception:
        return None


def heartbeat_timeout_s() -> float:
    return envflags.float_value(HEARTBEAT_GATE, DEFAULT_HEARTBEAT_TIMEOUT_S)


def evict_skew_ratio() -> float:
    """0 (the default) disables straggler draining — eviction is a
    cluster-operator policy, not something to switch on silently."""
    return envflags.float_value(EVICT_SKEW_RATIO_GATE, 0.0)


def evict_skew_splits() -> int:
    return max(1, envflags.int_value(EVICT_SKEW_SPLITS_GATE,
                                     DEFAULT_EVICT_SKEW_SPLITS))


def rejoin_backoff_s() -> float:
    return envflags.float_value(REJOIN_BACKOFF_GATE,
                                DEFAULT_REJOIN_BACKOFF_S)


class WorkerState(enum.Enum):
    JOINING = "joining"
    ACTIVE = "active"
    SUSPECT = "suspect"
    EVICTED = "evicted"
    REJOINING = "rejoining"


# evict reasons that are transient host failures — these auto-rejoin;
# drained stragglers and deterministic user exceptions stay out
_REJOINABLE_REASONS = frozenset({"host_loss", "heartbeat"})

# evict reasons that are PLANNED capacity decisions, not failures: the
# serving autoscaler draining its youngest replica on scale-in. These
# neither warn nor write an eviction flight bundle — an operator
# postmortem wants incident records for failures, not for the control
# loop doing its job (the scale event itself is recorded by
# dl4j_tpu_fleet_scale_events_total and a `fleet.scale` trace instant)
_PLANNED_REASONS = frozenset({"scale_in"})


@dataclass
class WorkerInfo:
    worker_id: WorkerId
    state: WorkerState = WorkerState.JOINING
    joined_generation: int = 0
    last_beat: Optional[float] = None  # a perf_counter stamp
    beats: int = 0
    slow_splits: int = 0               # consecutive splits past the ratio
    evict_reason: Optional[str] = None
    rejoin_not_before: Optional[float] = None
    rejoin_attempts: int = 0
    last_backoff: float = 0.0
    resume_split: Optional[int] = None
    # set on eviction: a parked worker thread (the heartbeat_drop arc)
    # waits on this instead of hanging the coordinator forever
    drain: threading.Event = field(default_factory=threading.Event)

    def to_json(self) -> Dict[str, Any]:
        return {"worker": str(self.worker_id), "state": self.state.value,
                "joined_generation": self.joined_generation,
                "beats": self.beats, "slow_splits": self.slow_splits,
                "evict_reason": self.evict_reason,
                "rejoin_attempts": self.rejoin_attempts,
                "resume_split": self.resume_split}


class MembershipRegistry:
    """Generation-numbered worker registry with per-split heartbeats.

    Thread-safe: executor threads heartbeat while the master thread runs
    detection/eviction; everything mutates under one RLock, and the
    per-worker ``drain`` Event is how an evicted-but-parked thread learns
    to stand down without the coordinator ever joining it unbounded.
    """

    def __init__(self,
                 heartbeat_timeout: Optional[float] = None,
                 skew_ratio: Optional[float] = None,
                 skew_splits: Optional[int] = None,
                 auto_rejoin: bool = True,
                 clock=time.perf_counter):
        # reentrant (snapshot() is called from locked regions); TrackedRLock
        # is a raw threading.RLock unless DL4J_TPU_LOCKCHECK turns the
        # sentinel on
        self._lock = TrackedRLock("distributed.membership.registry")
        self._workers: Dict[WorkerId, WorkerInfo] = {}  # guarded-by: self._lock
        self._heartbeat_timeout = heartbeat_timeout
        self._skew_ratio = skew_ratio
        self._skew_splits = skew_splits
        self.auto_rejoin = auto_rejoin
        self._clock = clock
        self.generation = 0  # guarded-by: self._lock
        self.splits_seen = 0  # guarded-by: self._lock
        # queued transition events for multi-controller routing
        # (runtime.coordinate_membership drains these collectively);
        # remote-applied events are NOT re-queued (no ping-pong)
        self._pending_events: List[Dict[str, Any]] = []  # guarded-by: self._lock
        self._applying_remote = False  # guarded-by: self._lock
        # flight-bundle context the owning master may provide
        self._flight_model = None
        self._flight_checkpoints = None
        # the owning fit's TraceContext (telemetry/context.py): stamps
        # membership-transition instants with the fit trace_id even when
        # the transition fires on a thread with no context attached
        self._trace_ctx = None

    # ------------------------------------------------------------------
    # config resolution (env gates re-read at use so tests can retune)
    # ------------------------------------------------------------------
    def _timeout(self) -> float:
        if self._heartbeat_timeout is not None:
            return self._heartbeat_timeout
        return heartbeat_timeout_s()

    def _ratio(self) -> float:
        if self._skew_ratio is not None:
            return self._skew_ratio
        return evict_skew_ratio()

    def _splits(self) -> int:
        if self._skew_splits is not None:
            return max(1, self._skew_splits)
        return evict_skew_splits()

    def timeout_s(self) -> float:
        """The effective missed-heartbeat window (constructor override or
        the DL4J_TPU_HEARTBEAT_TIMEOUT gate)."""
        return self._timeout()

    def set_flight_context(self, model=None, checkpoint_manager=None):
        """Attach the training context evictions should bundle (the
        flight recorder records what a postmortem needs: the dying model's
        analyzer estimates + the manifest a resume would restore)."""
        self._flight_model = model
        self._flight_checkpoints = checkpoint_manager

    def set_trace_context(self, ctx=None):
        """Attach (or clear, with None) the fit-level TraceContext the
        owning master minted: transition telemetry joins that trace no
        matter which thread detects the transition."""
        self._trace_ctx = ctx

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def register(self, worker_id: WorkerId) -> WorkerInfo:
        """JOINING -> ACTIVE; idempotent for already-active workers."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None and info.state in (WorkerState.ACTIVE,
                                                   WorkerState.SUSPECT):
                return info
            if info is None:
                info = WorkerInfo(worker_id)
                self._workers[worker_id] = info
            info.state = WorkerState.ACTIVE
            info.last_beat = self._clock()
            info.evict_reason = None
            info.drain = threading.Event()
            self.generation += 1
            info.joined_generation = self.generation
            self._transition("join", info)
            return info

    def heartbeat(self, worker_id: WorkerId) -> None:
        """One liveness stamp. A SUSPECT worker that beats before eviction
        is rescued back to ACTIVE (it was slow, not gone)."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None:
                return
            info.last_beat = self._clock()
            info.beats += 1
            if info.state is WorkerState.SUSPECT:
                info.state = WorkerState.ACTIVE

    def begin_split(self, split_index: Optional[int] = None) -> None:
        """Split boundary: restart every active worker's heartbeat window
        so the timeout measures silence WITHIN the split, not registry
        age."""
        with self._lock:
            self.splits_seen += 1
            now = self._clock()
            for info in self._workers.values():
                if info.state in (WorkerState.ACTIVE, WorkerState.SUSPECT):
                    info.last_beat = now

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def get(self, worker_id: WorkerId) -> Optional[WorkerInfo]:
        with self._lock:
            return self._workers.get(worker_id)

    def active_ids(self) -> List[WorkerId]:
        with self._lock:
            return [w for w, i in self._workers.items()
                    if i.state in (WorkerState.ACTIVE, WorkerState.SUSPECT)]

    def active_count(self) -> int:
        return len(self.active_ids())

    def is_active(self, worker_id: WorkerId) -> bool:
        with self._lock:
            info = self._workers.get(worker_id)
            return info is not None and info.state in (WorkerState.ACTIVE,
                                                       WorkerState.SUSPECT)

    def evicted_ids(self) -> List[WorkerId]:
        with self._lock:
            return [w for w, i in self._workers.items()
                    if i.state in (WorkerState.EVICTED,
                                   WorkerState.REJOINING)]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"generation": self.generation,
                    "splits_seen": self.splits_seen,
                    "active": [str(w) for w in sorted(
                        self.active_ids(), key=str)],
                    "workers": [i.to_json() for _, i in sorted(
                        self._workers.items(), key=lambda kv: str(kv[0]))]}

    # ------------------------------------------------------------------
    # failure detection
    # ------------------------------------------------------------------
    def report_failure(self, worker_id: WorkerId,
                       exc: Optional[BaseException] = None) -> None:
        """Exception-based detection: the master SAW this worker die.
        IO-shaped errors (ChaosError subclasses IOError; real torn
        sockets/preemptions surface as OSError) read as a lost host —
        transient, auto-rejoinable; anything else is an application
        error that would only fail again."""
        reason = "host_loss" if isinstance(exc, (OSError, ConnectionError)) \
            else "exception"
        self.evict(worker_id, reason, exc=exc)

    def suspect_silent(self, now: Optional[float] = None,
                       only=None) -> List[WorkerId]:
        """Missed-heartbeat detection pass. First detection marks a silent
        worker SUSPECT (one more beat rescues it); a worker already
        suspect and STILL silent is evicted. Returns newly-EVICTED ids so
        the master can requeue their in-flight shards.

        `only` scopes detection to those worker ids (the masters pass
        the workers with work IN FLIGHT — an idle survivor waiting out a
        long tail shard has nothing to beat about and must not read as
        silent); None checks everyone."""
        timeout = self._timeout()
        if timeout <= 0:
            return []
        only = None if only is None else set(only)
        evicted: List[WorkerId] = []
        with self._lock:
            now = self._clock() if now is None else now
            for worker_id, info in list(self._workers.items()):
                if only is not None and worker_id not in only:
                    continue
                if info.state not in (WorkerState.ACTIVE,
                                      WorkerState.SUSPECT):
                    continue
                age = now - (info.last_beat if info.last_beat is not None
                             else now)
                if age < timeout:
                    continue
                if info.state is WorkerState.ACTIVE:
                    info.state = WorkerState.SUSPECT
                    self._transition("suspect", info)
                else:
                    evicted.append(worker_id)
        for worker_id in evicted:
            self.evict(worker_id, "heartbeat")
        return evicted

    def mark_silent(self, worker_id: WorkerId) -> None:
        """Age the worker's heartbeat past the timeout so the next two
        detection passes suspect then evict it. The SPMD masters use this
        as the ``heartbeat_drop`` probe — one program gives one
        host-observed clock, so a silent LANE cannot be seen through real
        per-worker beats; routing the probe through the same detector
        keeps the suspect->evict arc identical across masters."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                info.last_beat = (self._clock()
                                  - 2.0 * max(1e-9, self._timeout()))

    def observe_split_durations(
            self, durations: Dict[WorkerId, float]) -> Dict[WorkerId, float]:
        """Straggler pass over one split's per-worker fit durations
        (seconds) — the skew windows the straggler gauges watch. A worker
        past DL4J_TPU_EVICT_SKEW_RATIO x median for
        DL4J_TPU_EVICT_SKEW_SPLITS consecutive splits is DRAINED (evicted,
        not auto-rejoined); its shard simply lands on survivors at the
        next split. Returns {worker: ratio}."""
        durs = {w: float(d) for w, d in durations.items()
                if d is not None and self.is_active(w)}
        if len(durs) < 2:
            return {}
        ordered = sorted(durs.values())
        mid = len(ordered) // 2
        median = (ordered[mid] if len(ordered) % 2
                  else 0.5 * (ordered[mid - 1] + ordered[mid]))
        if median <= 0:
            return {}
        ratio_gate = self._ratio()
        report: Dict[WorkerId, float] = {}
        to_drain: List[WorkerId] = []
        with self._lock:
            for worker_id, d in durs.items():
                ratio = d / median
                report[worker_id] = round(ratio, 3)
                info = self._workers.get(worker_id)
                if info is None or ratio_gate <= 0:
                    continue
                if ratio > ratio_gate:
                    info.slow_splits += 1
                    if info.slow_splits >= self._splits():
                        to_drain.append(worker_id)
                else:
                    info.slow_splits = 0
        for worker_id in to_drain:
            self.evict(worker_id, "straggler")
        return report

    # ------------------------------------------------------------------
    # eviction
    # ------------------------------------------------------------------
    def evict(self, worker_id: WorkerId, reason: str,
              exc: Optional[BaseException] = None,
              flight: bool = True) -> bool:
        """-> EVICTED: bump the generation, count the transition, wake any
        parked thread through the drain event, write a flight bundle
        (the black box records the eviction while the run is still
        alive), and — for transient reasons — schedule a jittered-backoff
        rejoin. Returns False when the worker was not active.

        `flight=False` suppresses the per-worker bundle for CASCADE
        evictions (multihost.py evicts every lane a lost host owned, then
        writes ONE host-level bundle — a postmortem wants one incident
        record per host loss, not one per lane)."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None or info.state in (WorkerState.EVICTED,
                                              WorkerState.REJOINING):
                return False
            info.state = WorkerState.EVICTED
            info.evict_reason = reason
            info.slow_splits = 0
            self.generation += 1
            rejoinable = self.auto_rejoin and reason in _REJOINABLE_REASONS
            if rejoinable:
                info.last_backoff = rejoin_backoff_s()
                info.rejoin_not_before = self._clock() + info.last_backoff
                info.rejoin_attempts = 0
            else:
                info.rejoin_not_before = None
            info.drain.set()
            self._transition(f"evict_{reason}", info, reason=reason)
            # captured for the bundle note below: reading them after the
            # lock drops could see a LATER eviction's generation
            gen = self.generation
            snap = self.snapshot()
        if reason in _PLANNED_REASONS:
            # a planned drain (autoscaler scale-in) is the control loop
            # working, not an incident: no warning, no eviction bundle
            return True
        warnings.warn(
            f"elastic membership: worker {worker_id} evicted "
            f"({reason}{': ' + str(exc) if exc else ''}); "
            f"{self.active_count()} worker(s) remain — its shard will be "
            f"rebalanced across survivors",
            stacklevel=2)
        if not flight:
            return True
        try:
            from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

            flight_mod.dump(
                "eviction", exc=exc, model=self._flight_model,
                checkpoint_manager=self._flight_checkpoints,
                note=f"worker {worker_id} evicted ({reason}) at generation "
                     f"{gen}; membership: {snap}")
        except Exception:  # the black box must never take down training
            pass  # a best-effort postmortem artifact
        return True

    # ------------------------------------------------------------------
    # rejoin: the coordinated checkpoint barrier
    # ------------------------------------------------------------------
    def barrier(self, splits_done: int, model=None,
                checkpoint_manager=None) -> List[WorkerId]:
        """Split-boundary barrier: admit due rejoin candidates. All
        members agree on the resume split through the atomic checkpoint
        manifest when a manager is present (the checkpoint machinery — a
        rejoiner resumes from what the manifest says, not from what it
        remembers); without one the in-memory ``splits_done`` is the
        agreement. The chaos ``rejoin`` fault point fires inside
        admission — a failed first barrier reschedules the worker with
        decorrelated backoff so a mass rejoin cannot thundering-herd the
        checkpoint dir. Returns the admitted worker ids."""
        with self._lock:
            now = self._clock()
            due = [i for i in self._workers.values()
                   if i.state is WorkerState.EVICTED
                   and i.rejoin_not_before is not None
                   and now >= i.rejoin_not_before]
            for info in due:
                info.state = WorkerState.REJOINING
        admitted: List[WorkerId] = []
        for info in due:
            try:
                chaos.fault_point("rejoin")
                resume = int(splits_done)
                if checkpoint_manager is not None:
                    manifests = checkpoint_manager.manifests()
                    if manifests:
                        m = manifests[-1]
                        resume = int(m.get("splits_done", m.get("step",
                                                                resume)))
                with self._lock:
                    info.resume_split = resume
                    info.state = WorkerState.ACTIVE
                    info.last_beat = self._clock()
                    info.evict_reason = None
                    info.rejoin_not_before = None
                    info.drain = threading.Event()
                    self.generation += 1
                    self._transition("rejoin", info)
                admitted.append(info.worker_id)
            except Exception as exc:
                # rejoin is best-effort RECOVERY, not a correctness path:
                # any admission failure — the chaos `rejoin` point or a
                # real one (flaky checkpoint dir raising OSError from the
                # manifest read) — backs the worker off and retries at a
                # later barrier. Raising would kill a healthy degraded
                # run, and leaving the worker REJOINING would strand it
                # forever (the `due` filter only selects EVICTED).
                if not isinstance(exc, chaos.ChaosError):
                    warnings.warn(
                        f"rejoin barrier admission for worker "
                        f"{info.worker_id} failed ({exc}); backing off",
                        stacklevel=2)
                with self._lock:
                    info.state = WorkerState.EVICTED
                    info.rejoin_attempts += 1
                    info.last_backoff = decorrelated_backoff(
                        info.last_backoff, rejoin_backoff_s(),
                        cap=REJOIN_BACKOFF_CAP_S)
                    info.rejoin_not_before = (self._clock()
                                              + info.last_backoff)
                    self._transition("rejoin_failed", info)
        return admitted

    # ------------------------------------------------------------------
    # transition plumbing
    # ------------------------------------------------------------------
    def _transition(self, event: str, info: WorkerInfo,
                    reason: str = "") -> None:
        """Record one transition: telemetry (counter + gauges + trace
        instant) and the multi-controller event queue. Called under the
        lock."""
        active = sum(1 for i in self._workers.values()
                     if i.state in (WorkerState.ACTIVE, WorkerState.SUSPECT))
        if context_mod.current() is None and self._trace_ctx is not None:
            # a transition detected off the fit's thread (watchdog,
            # executor teardown) still joins the fit trace
            with context_mod.activate(self._trace_ctx):
                health_mod.observe_membership_transition(
                    event, worker=info.worker_id,
                    generation=self.generation, active=active,
                    reason=reason)
        else:
            health_mod.observe_membership_transition(
                event, worker=info.worker_id, generation=self.generation,
                active=active, reason=reason)
        if not self._applying_remote:
            self._pending_events.append({
                "event": event, "worker": str(info.worker_id),
                "generation": self.generation, "reason": reason,
                # host attribution for multi-host postmortems; None in
                # single-process runs (the flight-bundle convention)
                "process_index": _host_process_index()})

    def drain_pending_events(self) -> List[Dict[str, Any]]:
        """Hand the queued transition events to the multi-controller
        router (runtime.coordinate_membership) and clear the queue."""
        with self._lock:
            out, self._pending_events = self._pending_events, []
            return out

    def apply_remote_event(self, event: Dict[str, Any],
                           origin: Optional[int] = None) -> None:
        """Apply a transition another controller observed. Remote workers
        are namespaced ``p{origin}:{worker}`` so every process holds the
        same global membership view without id collisions. Events for
        our own namespace are ignored (already applied locally)."""
        if not event.get("event") or not event.get("worker"):
            return
        wid = f"p{origin}:{event['worker']}" if origin is not None \
            else str(event["worker"])
        kind = event["event"]
        # the flag is read by _transition under the lock (it decides
        # whether to re-queue the event); setting it unlocked lets a
        # concurrent local transition observe a half-applied remote
        with self._lock:
            self._applying_remote = True
        try:
            if kind == "join" or kind == "rejoin":
                self.register(wid)
            elif kind.startswith("evict_"):
                self.register(wid)  # idempotent: ensure it exists to evict
                # remote eviction is authoritative — apply without
                # re-running local detection, and never auto-rejoin on the
                # remote's behalf (its own barrier drives that, then
                # routes a rejoin event here)
                with self._lock:
                    info = self._workers[wid]
                    if info.state not in (WorkerState.EVICTED,
                                          WorkerState.REJOINING):
                        info.state = WorkerState.EVICTED
                        info.evict_reason = event.get("reason") or kind[6:]
                        info.rejoin_not_before = None
                        info.drain.set()
                        self.generation += 1
                        self._transition(kind, info,
                                         reason=info.evict_reason or "")
        finally:
            with self._lock:
                self._applying_remote = False
