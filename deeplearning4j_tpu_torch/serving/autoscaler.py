"""Autoscaler — an elastic, self-sizing pool of replica InferenceServers
(counterpart of deeplearning4j_tpu/serving/autoscaler.py: the same signals
scale on the same ticks in both packages).

One Autoscaler owns N `ReplicaServer`s that share a dispatch (and
optionally a serving/tenancy.py controller, so quotas and weighted
fairness span the whole pool) behind the Router:

  signals      each `evaluate()` aggregates the pool's queue-depth p50
               and dispatch-latency EMA from replica snapshots — the
               same rings the servers' snapshots report, no new
               bookkeeping.
  hysteresis   scale OUT when either signal breaches its high band
               (`queue_depth_high`, `ema_high_s`); scale IN only when
               BOTH sit under their low bands — the gap between bands
               is the hysteresis that keeps a flapping signal from
               flapping the fleet.
  storm guard  a minimum dwell (`min_dwell_s`) between scale events
               makes oscillation structurally impossible: inside the
               dwell window `evaluate()` refuses to act (and the
               snapshot reports `storm_guard_active`).
  scale OUT    spawn through the factory; a factory built by
               `Autoscaler.for_model` boots the replica with the
               registry's warm manifest's example (serving/warmstart.py),
               so a spawned replica dispatches every bucket once before
               it takes traffic. A failed spawn (chaos fault point
               `replica_spawn`) retries on later evaluate ticks with
               decorrelated backoff; ONE flight bundle is written per
               failure EPISODE (the rising edge), not per attempt.
  scale IN     drain the YOUNGEST replica via the runtime's
               drain-on-shutdown (its queued requests resolve, then the
               server stops) and evict it from membership with the
               planned reason `scale_in` (no warning, no incident
               bundle).
  lifecycle    replicas live in a distributed/membership.py registry —
               joining -> active -> suspect -> evicted. `evaluate()`
               heartbeats healthy replicas and `suspect_silent()` walks
               silent ones to eviction; a replica whose dispatcher
               CRASHES mid-dispatch is evicted immediately (reason
               `crash`, incident bundle via membership) and
               `output()` requeues the caller onto a survivor — every
               in-flight request resolves with a result or a typed
               ServingError, never a hang.
  pull-driven  nothing here owns a thread: `Router.evaluate()` or the
               caller's loop IS the control cadence, exactly like the
               SLO engine and rollout controller. The only threads are
               the replica dispatchers the runtime already owns.

Replicas of one model on one card share the model's weights: each is an
InferenceServer with its own queue, breaker and dispatcher thread over the
same network object.

Telemetry: `dl4j_tpu_fleet_replicas` (gauge),
`dl4j_tpu_fleet_scale_events_total{direction,reason}` (counter), a
Chrome `fleet.scale` instant per event carrying the triggering signal
snapshot, every replica registered as a fleet source
(telemetry/aggregate.py), and `fleet_section()`, the JAX package's /fleet
payload.

Chaos fault point (resilience/chaos.py grammar):

    replica_spawn  the replica factory call raises ChaosError — the
                   spawn-retry / flight-episode arc.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.distributed.membership import MembershipRegistry
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.resilience.retry import decorrelated_backoff
from deeplearning4j_tpu_torch.serving.errors import (
    DispatcherCrashedError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util.locks import TrackedRLock

_REPLICAS_GAUGE = metrics_mod.gauge(
    "dl4j_tpu_fleet_replicas",
    "Live replica servers in the autoscaled pool")
_SCALE_EVENTS = metrics_mod.counter(
    "dl4j_tpu_fleet_scale_events_total",
    "Fleet scale events, by direction (out/in) and triggering reason",
    labelnames=("direction", "reason"))

# live autoscalers for fleet_section (weak: a dropped pool must not pin
# itself — the _SERVERS pattern from serving/runtime.py)
_AUTOSCALERS: "weakref.WeakSet[Autoscaler]" = weakref.WeakSet()


class ReplicaServer:
    """One pool member: a replica id in the membership registry bound to
    its own InferenceServer; `born` orders scale-in (youngest drains
    first)."""

    __slots__ = ("replica_id", "server", "born")

    def __init__(self, replica_id: str, server, born: float):
        self.replica_id = replica_id
        self.server = server
        self.born = born


def fleet_section() -> Optional[dict]:
    """Pool state over every LIVE autoscaler (the JAX package's /fleet
    payload and /healthz merge); None when no pool exists."""
    pools = [a for a in list(_AUTOSCALERS) if not a.stopped]
    if not pools:
        return None
    snaps = [a.snapshot() for a in pools]
    return {
        "pools": snaps,
        "replicas": sum(s["replicas_live"] for s in snaps),
        "storm_guard_active": any(s["storm_guard_active"] for s in snaps),
        "tenant_slo_firing": sorted(
            {name for s in snaps for name in s["tenant_slo_firing"]}),
    }


class Autoscaler:
    """Elastic replica pool with hysteresis, dwell, and typed failure.

    `server_factory(replica_name, tenancy)` must return a STARTED
    InferenceServer; `Autoscaler.for_model` builds one from a registered
    ModelVersion that boots through the warm-start manifest. The
    constructor spawns `min_replicas` immediately (chaos can defer that
    to the first `evaluate()` tick via spawn-retry)."""

    def __init__(self, server_factory: Callable,
                 min_replicas: int = 1, max_replicas: int = 4,
                 queue_depth_high: float = 8.0,
                 queue_depth_low: float = 1.0,
                 ema_high_s: float = 0.25,
                 ema_low_s: float = 0.05,
                 min_dwell_s: float = 5.0,
                 spawn_backoff_base_s: float = 0.05,
                 spawn_backoff_cap_s: float = 2.0,
                 tenancy=None,
                 membership: Optional[MembershipRegistry] = None,
                 version: str = "v1",
                 name: str = "fleet",
                 clock: Callable[[], float] = time.monotonic,
                 rng=None):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.name = name
        self.version = version
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_depth_high = float(queue_depth_high)
        self.queue_depth_low = float(queue_depth_low)
        self.ema_high_s = float(ema_high_s)
        self.ema_low_s = float(ema_low_s)
        self.min_dwell_s = float(min_dwell_s)
        self.spawn_backoff_base_s = float(spawn_backoff_base_s)
        self.spawn_backoff_cap_s = float(spawn_backoff_cap_s)
        self.tenancy = tenancy
        # replicas never auto-rejoin: the pool spawns FRESH warm replicas
        # instead of readmitting a crashed dispatcher's corpse
        self.membership = membership or MembershipRegistry(auto_rejoin=False)
        self._factory = server_factory
        self._clock = clock
        self._rng = rng
        self._lock = TrackedRLock("serving.autoscaler.pool")
        self._replicas: List[ReplicaServer] = []  # guarded-by: self._lock
        self._seq = 0  # guarded-by: self._lock
        self._rr = 0  # guarded-by: self._lock
        self._last_scale_t: Optional[float] = None  # guarded-by: self._lock
        self._events: "List[dict]" = []  # guarded-by: self._lock
        # spawn-failure episode: backoff state + the one-bundle edge
        self._spawn_failures = 0  # guarded-by: self._lock
        self._spawn_backoff_s = 0.0  # guarded-by: self._lock
        self._spawn_retry_at: Optional[float] = None  # guarded-by: self._lock
        self._spawn_episode_open = False  # guarded-by: self._lock
        self._stopped = False
        _AUTOSCALERS.add(self)
        now = self._clock()
        for _ in range(self.min_replicas):
            if self._spawn(now, "min_replicas") is None:
                break  # chaos at boot: evaluate() retries with backoff

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def for_model(cls, registry, model: str, version: Optional[str] = None,
                  tenancy=None, **kwargs) -> "Autoscaler":
        """A pool over a registered ModelVersion: replicas clone its
        unwrapped dispatch + serving policy (the same network, so the
        same weights) and warm up from the registry's warm manifest when
        one is recorded."""
        mv = registry.get(model, version)
        if mv.dispatch is None:
            raise ValueError(f"{mv.key} has no replica dispatch recorded")

        def factory(replica_name: str, tenancy_ctrl,
                    _mv=mv, _registry=registry):
            from deeplearning4j_tpu_torch.serving.runtime import InferenceServer

            kw = dict(_mv.server_kwargs)
            kw["name"] = replica_name
            example = _registry.replica_example(_mv)
            if example is not None:
                kw["warmup_example"] = example
            return InferenceServer(dispatch=_mv.dispatch,
                                   tenancy=tenancy_ctrl, **kw)

        kwargs.setdefault("name", f"{model}-fleet")
        return cls(factory, tenancy=tenancy, version=mv.version, **kwargs)

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def output(self, x, deadline_s: Optional[float] = None,
               tenant: Optional[str] = None) -> np.ndarray:
        """Route one request to a replica (round-robin over the live
        pool). A replica that turns out to have a CRASHED dispatcher is
        evicted and the request requeues onto a survivor — the caller
        sees a result or a typed ServingError, never the corpse."""
        last: Optional[BaseException] = None
        for _ in range(self.max_replicas + 1):
            rep = self._pick()
            if rep is None:
                raise (last if last is not None else
                       ShutdownError(f"fleet {self.name!r} has no live "
                                     f"replicas"))
            try:
                return rep.server.output(x, deadline_s=deadline_s,
                                         tenant=tenant)
            except DispatcherCrashedError as e:
                last = e
                self._on_replica_crash(rep, e)
        raise last

    def _pick(self) -> Optional[ReplicaServer]:
        with self._lock:
            live = [r for r in self._replicas if not r.server.stopped]
            if not live:
                return None
            self._rr = (self._rr + 1) % len(live)
            return live[self._rr]

    # ------------------------------------------------------------------
    # the pull-driven control tick
    # ------------------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Optional[str]:
        """One control tick (the caller is the cadence): reap crashed
        replicas, heartbeat the rest, walk silent ones to eviction, then
        apply the hysteresis/dwell decision. Returns the action taken
        ('out', 'in', None)."""
        if self._stopped:
            return None
        now = self._clock() if now is None else now
        self._reap_and_heartbeat(now)
        with self._lock:
            n = len(self._replicas)
            signals = self._signals_locked()
            retry_due = (self._spawn_retry_at is not None
                         and now >= self._spawn_retry_at)
            retry_wait = (self._spawn_retry_at is not None
                          and now < self._spawn_retry_at)
            dwell = self._storm_guard_active_locked(now)
            if n < self.min_replicas:
                action = None if retry_wait else ("out", "min_replicas")
            elif retry_wait:
                action = None  # a failed spawn episode owns the cadence
            elif retry_due:
                action = ("out", "spawn_retry")
            elif dwell:
                action = None
            elif n < self.max_replicas and (
                    signals["queue_depth_p50"] >= self.queue_depth_high
                    or (signals["ema_latency_s"] is not None
                        and signals["ema_latency_s"] >= self.ema_high_s)):
                reason = ("queue_depth"
                          if signals["queue_depth_p50"]
                          >= self.queue_depth_high else "latency")
                action = ("out", reason)
            elif n > self.min_replicas and (
                    signals["queue_depth_p50"] <= self.queue_depth_low
                    and (signals["ema_latency_s"] is None
                         or signals["ema_latency_s"] <= self.ema_low_s)):
                action = ("in", "idle")
            else:
                action = None
        if action is None:
            return None
        direction, reason = action
        if direction == "out":
            rep = self._spawn(now, reason, signals=signals)
            return "out" if rep is not None else None
        self._scale_in(now, reason, signals=signals)
        return "in"

    def _reap_and_heartbeat(self, now: float) -> None:
        with self._lock:
            reps = list(self._replicas)
        crashed = [r for r in reps if r.server.crashed]
        for rep in crashed:
            self._on_replica_crash(
                rep, DispatcherCrashedError(
                    f"replica {rep.replica_id} dispatcher died"))
        for rep in reps:
            if not rep.server.crashed and not rep.server.stopped:
                self.membership.heartbeat(rep.replica_id)
        # silent replicas walk ACTIVE -> SUSPECT -> EVICTED on membership
        # cadence; drop any the registry evicted from under us
        gone = set(self.membership.suspect_silent())
        if gone:
            with self._lock:
                dead = [r for r in self._replicas if r.replica_id in gone]
                self._replicas = [r for r in self._replicas
                                  if r.replica_id not in gone]
                _REPLICAS_GAUGE.set(len(self._replicas))
            for rep in dead:
                rep.server.shutdown(timeout=1.0)

    # ------------------------------------------------------------------
    # signals + guards
    # ------------------------------------------------------------------
    def _signals_locked(self) -> Dict[str, Optional[float]]:
        depths, emas = [], []
        for rep in self._replicas:
            snap = rep.server.snapshot()
            d = snap["queue_depth_p50"]
            depths.append(snap["queue_depth"] if d is None else
                          max(d, snap["queue_depth"]))
            if snap["ema_latency_s"] is not None:
                emas.append(snap["ema_latency_s"])
        return {
            "replicas": len(self._replicas),
            "queue_depth_p50": (sum(depths) / len(depths)) if depths
            else 0.0,
            "ema_latency_s": (sum(emas) / len(emas)) if emas else None,
        }

    def _storm_guard_active_locked(self, now: float) -> bool:
        return (self._last_scale_t is not None
                and now - self._last_scale_t < self.min_dwell_s)

    def storm_guard_active(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            return self._storm_guard_active_locked(now)

    # ------------------------------------------------------------------
    # scale out / in
    # ------------------------------------------------------------------
    def _spawn(self, now: float, reason: str,
               signals: Optional[dict] = None) -> Optional[ReplicaServer]:
        with self._lock:
            self._seq += 1
            rid = f"{self.name}-r{self._seq}"
        try:
            # the fault point and the factory both run OUTSIDE the pool
            # lock: a warmup dispatch or an injected fault must never
            # wedge routing
            chaos.fault_point("replica_spawn")
            server = self._factory(rid, self.tenancy)
        except Exception as e:
            self._note_spawn_failure(now, e)
            return None
        self.membership.register(rid)
        rep = ReplicaServer(rid, server, born=now)
        with self._lock:
            self._replicas.append(rep)
            n = len(self._replicas)
            self._close_spawn_episode_locked()
        _REPLICAS_GAUGE.set(n)
        # fleet federation: every replica is a telemetry source from its
        # first breath (no-op while the telemetry gate is off); its
        # frames carry per-replica gauges from the server's own snapshot
        # — the process registry ships once, on the host-level source,
        # registered alongside the first replica (idempotent)
        from deeplearning4j_tpu_torch.telemetry import aggregate as agg_mod

        agg_mod.register_local_host()
        agg_mod.register_replica(rid, server.snapshot)
        self._record_event("out", reason, now, n, signals)
        return rep

    def _scale_in(self, now: float, reason: str,
                  signals: Optional[dict] = None) -> None:
        with self._lock:
            if len(self._replicas) <= self.min_replicas:
                return
            youngest = max(self._replicas, key=lambda r: r.born)
            self._replicas.remove(youngest)
            n = len(self._replicas)
        _REPLICAS_GAUGE.set(n)
        # drain OUTSIDE the lock: shutdown waits on the dispatcher to
        # finish its in-flight batch
        youngest.server.shutdown()
        self.membership.evict(youngest.replica_id, "scale_in", flight=False)
        from deeplearning4j_tpu_torch.telemetry import aggregate as agg_mod

        agg_mod.deregister_replica(youngest.replica_id)
        self._record_event("in", reason, now, n, signals)

    def _on_replica_crash(self, rep: ReplicaServer,
                          exc: BaseException) -> None:
        with self._lock:
            if rep not in self._replicas:
                return  # another caller already reaped it
            self._replicas.remove(rep)
            n = len(self._replicas)
        _REPLICAS_GAUGE.set(n)
        # membership writes the incident bundle (reason `crash` is not
        # planned); the crashed server's own drain already resolved its
        # queue with DispatcherCrashedError — typed, never a hang
        self.membership.evict(rep.replica_id, "crash", exc=exc)
        from deeplearning4j_tpu_torch.telemetry import aggregate as agg_mod

        agg_mod.deregister_replica(rep.replica_id)
        self._record_event("in", "crash", self._clock(), n, None,
                           count_dwell=False)

    def _note_spawn_failure(self, now: float, exc: BaseException) -> None:
        with self._lock:
            self._spawn_failures += 1
            first = not self._spawn_episode_open
            self._spawn_episode_open = True
            self._spawn_backoff_s = decorrelated_backoff(
                self._spawn_backoff_s or self.spawn_backoff_base_s,
                self.spawn_backoff_base_s, self.spawn_backoff_cap_s,
                rng=self._rng)
            self._spawn_retry_at = now + self._spawn_backoff_s
            failures = self._spawn_failures
            backoff_s = self._spawn_backoff_s
        if first:
            # ONE bundle per failure episode: the rising edge records
            # the incident; retries inside the episode only extend it
            try:
                from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

                flight_mod.dump(
                    "replica_spawn", exc=exc,
                    note=f"fleet {self.name!r} replica spawn failed "
                         f"({type(exc).__name__}: {exc}); retrying with "
                         f"decorrelated backoff")
            except Exception:
                pass  # a best-effort postmortem artifact
        tr = trace_mod.tracer()
        if tr.enabled:
            tr.add_instant("fleet.spawn_failed", category="serving",
                           fleet=self.name, failures=failures,
                           retry_in_s=round(backoff_s, 4))

    def _close_spawn_episode_locked(self) -> None:
        self._spawn_episode_open = False
        self._spawn_failures = 0
        self._spawn_backoff_s = 0.0
        self._spawn_retry_at = None

    def _record_event(self, direction: str, reason: str, now: float,
                      replicas: int, signals: Optional[dict],
                      count_dwell: bool = True) -> None:
        _SCALE_EVENTS.labels(direction, reason).inc()
        event = {"direction": direction, "reason": reason, "t": now,
                 "replicas": replicas}
        if signals is not None:
            event["signals"] = {k: v for k, v in signals.items()
                                if k != "replicas"}
        with self._lock:
            if count_dwell:
                self._last_scale_t = now
            self._events.append(event)
            del self._events[:-64]  # ring: the last 64 events
        tr = trace_mod.tracer()
        if tr.enabled:
            kw = dict(event.get("signals") or {})
            tr.add_instant("fleet.scale", category="serving",
                           fleet=self.name, direction=direction,
                           reason=reason, replicas=replicas, **kw)

    # ------------------------------------------------------------------
    # lifecycle / views
    # ------------------------------------------------------------------
    @property
    def stopped(self) -> bool:
        return self._stopped

    def shutdown(self, timeout: float = 5.0) -> None:
        """Drain every replica (drain-on-shutdown per server) and stop.
        Idempotent."""
        self._stopped = True
        with self._lock:
            reps = list(self._replicas)
            self._replicas = []
        from deeplearning4j_tpu_torch.telemetry import aggregate as agg_mod

        for rep in reps:
            rep.server.shutdown(timeout=timeout)
            self.membership.evict(rep.replica_id, "scale_in", flight=False)
            agg_mod.deregister_replica(rep.replica_id)
        _REPLICAS_GAUGE.set(0)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Machine-readable pool state (the JAX package's /fleet and
        /healthz payload)."""
        from deeplearning4j_tpu_torch.telemetry import slo as slo_mod

        now = self._clock() if now is None else now
        with self._lock:
            reps = list(self._replicas)
            signals = self._signals_locked()
            snap = {
                "name": self.name,
                "version": self.version,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "replicas_live": len(reps),
                "signals": {k: v for k, v in signals.items()
                            if k != "replicas"},
                "bands": {
                    "queue_depth_high": self.queue_depth_high,
                    "queue_depth_low": self.queue_depth_low,
                    "ema_high_s": self.ema_high_s,
                    "ema_low_s": self.ema_low_s,
                    "min_dwell_s": self.min_dwell_s,
                },
                "storm_guard_active":
                    self._storm_guard_active_locked(now),
                "spawn": {
                    "episode_open": self._spawn_episode_open,
                    "failures": self._spawn_failures,
                    "retry_in_s": (
                        round(max(0.0, self._spawn_retry_at - now), 4)
                        if self._spawn_retry_at is not None else None),
                },
                "events": list(self._events[-16:]),
            }
        replicas = []
        for rep in reps:
            info = self.membership.get(rep.replica_id)
            r = rep.server.snapshot()
            r["replica_id"] = rep.replica_id
            r["state"] = info.state.value if info is not None else "unknown"
            replicas.append(r)
        snap["replica_servers"] = replicas
        snap["membership"] = self.membership.snapshot()
        snap["tenants"] = (self.tenancy.snapshot()["tenants"]
                           if self.tenancy is not None else None)
        # the isolation gate: per-tenant SLO rules currently firing
        # (slo.tenant_rules names them tenant_*)
        eng = slo_mod.engine()
        snap["tenant_slo_firing"] = sorted(
            name for name in (eng.firing() if eng is not None else ())
            if name.startswith("tenant_"))
        return snap
