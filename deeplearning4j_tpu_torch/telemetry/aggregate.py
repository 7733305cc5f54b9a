"""FleetCollector — one pane of glass across hosts and replicas
(counterpart of deeplearning4j_tpu/telemetry/aggregate.py: the same frames
give the same merge and the same delivery counters in both packages).

Merges telemetry frames (telemetry/export.py) from many sources into
fleet-level truth:

  * **metrics** — every family re-labeled under ``{host, replica}``.
    Counters merge exactly-once BY CONSTRUCTION: a frame carries the
    source's cumulative state, the collector keeps only the highest-seq
    snapshot per source, and the fleet value is the sum of those
    snapshots — a dropped, duplicated, or reordered frame can shift
    staleness but can never double-count. Gauges keep their per-source
    children plus fleet min/max/sum aggregates (``<name>_fleet{agg=}``).
    Histograms merge bin-for-bin after bucket-boundary validation
    (metrics.Histogram.merge_cumulative) — mismatched bucketings raise
    into a conflict counter instead of fabricating quantiles.
  * **traces** — per-source ring deltas accumulate into ONE Chrome JSON:
    a lane group (synthetic pid + ``process_name`` metadata) per host,
    ``thread_name`` lanes preserved, and cross-process ``trace_id`` /
    flow ids intact. Clock skew per source is estimated from frame
    exchange (receive wall-time minus ``sent_at``; the minimum over
    frames bounds offset + fastest transport) and stamped as drift
    metadata — span timestamps are never rewritten.
  * **fleet SLO** — the slo.py rule grammar runs a second, federated
    engine over the merged registry, so burn diluted across replicas
    (invisible to every local engine) still fires: ONE fleet episode,
    ONE flight bundle (reason ``fleet_slo_burn``) joining the offending
    trace events across sources.

Transport-agnostic sequencing: frames are applied exactly once by
(source, seq). Delivery anomalies are counted on
``dl4j_tpu_fleet_frames_{dropped,duplicate,late}_total{host,replica}``:
a gap is held as *missing* for one subsequent arrival (the reorder
grace) before being declared dropped; a missing seq that shows up late
is merged and counted late, never dropped. ``finalize()`` flushes the
grace window (end of a drain).

The ``frame_drop`` chaos point (resilience/chaos.py) fires in
``deliver()`` — the transport boundary — and cycles drop → duplicate →
reorder per firing, so one ``DL4J_TPU_CHAOS=frame_drop@...`` schedule
proves the whole exactly-once contract.

Pull-driven, zero new threads: ``poll()`` pulls frames from registered
in-process sources (the autoscaler's replicas, the local host) and
drains spool directories. Gate: ``DL4J_TPU_TELEMETRY`` — ``collector()``
returns None while off, allocating nothing.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util import envflags

TRACE_BUFFER_GATE = "DL4J_TPU_FLEET_TRACE_BUFFER"
_DEFAULT_TRACE_BUFFER = 65536
_APPLIED_WINDOW = 4096  # seq-dedup memory per source
_REORDER_GRACE = 1      # arrivals a gap survives before "dropped"

_FRAMES = metrics_mod.counter(
    "dl4j_tpu_fleet_frames_total",
    "Telemetry frames merged into the fleet collector",
    labelnames=("host", "replica"))
_DROPPED = metrics_mod.counter(
    "dl4j_tpu_fleet_frames_dropped_total",
    "Frame sequence gaps declared lost (reorder grace expired)",
    labelnames=("host", "replica"))
_DUPLICATE = metrics_mod.counter(
    "dl4j_tpu_fleet_frames_duplicate_total",
    "Frames re-delivered with an already-applied sequence number",
    labelnames=("host", "replica"))
_LATE = metrics_mod.counter(
    "dl4j_tpu_fleet_frames_late_total",
    "Frames that arrived out of order but unseen (merged, not dropped)",
    labelnames=("host", "replica"))
_CONFLICTS = metrics_mod.counter(
    "dl4j_tpu_fleet_merge_conflicts_total",
    "Metric families skipped in a fleet merge (type/label/bucket clash)",
    labelnames=("metric",))

_CHAOS_MODES = ("drop", "duplicate", "reorder")


@dataclass
class _SourceState:
    host: str
    replica: str
    live: bool = True
    puller: Optional[Callable[[], Optional[Dict[str, Any]]]] = None
    max_seq: int = 0
    applied: Set[int] = field(default_factory=set)
    missing: Dict[int, int] = field(default_factory=dict)  # seq -> age left
    metrics: Dict[str, Any] = field(default_factory=dict)
    health: Optional[Dict[str, Any]] = None
    knobs: Dict[str, Any] = field(default_factory=dict)
    flight_dir: Optional[str] = None
    flight_index: Tuple[str, ...] = ()
    trace: deque = field(default_factory=lambda: deque(
        maxlen=envflags.int_value(TRACE_BUFFER_GATE,
                                  _DEFAULT_TRACE_BUFFER)))
    thread_names: Dict[str, str] = field(default_factory=dict)
    frames: int = 0
    skew_last_s: Optional[float] = None
    skew_min_s: Optional[float] = None

    @property
    def key(self) -> Tuple[str, str]:
        return (self.host, self.replica)


class FleetCollector:
    """Pull-driven frame merger. Construction starts no threads and
    registers no sources; everything happens on the caller's tick."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: Dict[Tuple[str, str], _SourceState] = {}  # guarded-by: self._lock
        self._spools: Dict[str, Set[str]] = {}  # dir -> ingested names, guarded-by: self._lock
        self._held: List[Dict[str, Any]] = []  # reorder chaos stash, guarded-by: self._lock
        self._chaos_fires = 0  # guarded-by: self._lock
        self._dirty = True  # guarded-by: self._lock
        self._registry = metrics_mod.MetricsRegistry()  # guarded-by: self._lock
        self._slo: Optional[Any] = None  # guarded-by: self._lock

    # -- membership ---------------------------------------------------
    def register_source(
            self, host: str, replica: str = "-",
            puller: Optional[Callable[[], Optional[Dict[str, Any]]]] = None,
    ) -> None:
        """Announce a source. ``puller`` (optional) is a zero-arg
        callable returning that source's next frame; ``poll()`` invokes
        it each tick — this is how the autoscaler's replicas and the
        local host exporter join without any push path."""
        key = (str(host), str(replica))
        with self._lock:
            st = self._sources.get(key)
            if st is None:
                st = self._sources[key] = _SourceState(*key)
            st.live = True
            if puller is not None:
                st.puller = puller

    def deregister_source(self, host: str, replica: str = "-") -> None:
        """Stop pulling a source. Its merged history STAYS: a drained
        replica's requests still happened, so its counters remain in
        the fleet totals (monotonicity — fleet counters never step
        backward on scale-in)."""
        with self._lock:
            st = self._sources.get((str(host), str(replica)))
            if st is not None:
                st.live = False
                st.puller = None

    def attach_spool(self, directory: str) -> None:
        """Watch a spool directory of frame files (export.spool): each
        ``poll()`` ingests files not seen before — the cross-process
        shipping path."""
        with self._lock:
            self._spools.setdefault(str(directory), set())

    # -- delivery (transport boundary; chaos lives here) --------------
    def deliver(self, frame: Dict[str, Any],
                received_at: Optional[float] = None) -> None:
        """Transport-facing entry: applies the ``frame_drop`` chaos
        point, then ingests. Chaos firings cycle drop → duplicate →
        reorder (hold until the next delivery) so one schedule
        exercises every anomaly the sequencing must absorb."""
        from deeplearning4j_tpu_torch.resilience import chaos

        if chaos.silent_fault("frame_drop"):
            with self._lock:
                self._chaos_fires += 1
                mode = _CHAOS_MODES[(self._chaos_fires - 1)
                                    % len(_CHAOS_MODES)]
            if mode == "drop":
                return
            if mode == "duplicate":
                self.ingest(frame, received_at)
                self.ingest(frame, received_at)
                return
            with self._lock:
                self._held.append(frame)
            return
        self.ingest(frame, received_at)
        with self._lock:
            held, self._held = self._held, []
        for h in held:
            self.ingest(h, received_at)

    # -- merge --------------------------------------------------------
    def ingest(self, frame: Dict[str, Any],
               received_at: Optional[float] = None) -> str:
        """Apply one frame exactly once by (source, seq). Returns what
        happened: ``applied`` / ``late`` / ``duplicate``."""
        src = frame.get("source") or {}
        host = str(src.get("host", "?"))
        replica = str(src.get("replica", "-"))
        seq = int(frame.get("seq", 0))
        recv = time.time() if received_at is None else received_at
        with self._lock:
            st = self._sources.get((host, replica))
            if st is None:
                st = self._sources[(host, replica)] = _SourceState(
                    host, replica)
            if seq in st.applied or (st.max_seq and seq not in st.missing
                                     and seq <= st.max_seq - _APPLIED_WINDOW):
                # already applied, or from before the dedup window (a
                # seq that old and unmissed can only be a re-delivery)
                _DUPLICATE.labels(host, replica).inc()
                return "duplicate"
            outcome = "applied"
            # age existing gaps BEFORE opening new ones: a gap must not
            # expire on the very arrival that revealed it
            expired = [s for s, age in st.missing.items() if age <= 0]
            for s in expired:
                del st.missing[s]
                _DROPPED.labels(host, replica).inc()
            for s in list(st.missing):
                st.missing[s] -= 1
            if seq in st.missing:
                del st.missing[seq]
                _LATE.labels(host, replica).inc()
                outcome = "late"
            elif st.max_seq and seq < st.max_seq:
                _LATE.labels(host, replica).inc()
                outcome = "late"
            elif seq > st.max_seq + 1:
                # covers max_seq == 0 too: frames lost before the FIRST
                # delivery (stream opens at seq 3) are gaps like any other
                for s in range(st.max_seq + 1, seq):
                    st.missing[s] = _REORDER_GRACE
            st.applied.add(seq)
            if len(st.applied) > _APPLIED_WINDOW:
                horizon = max(st.applied) - _APPLIED_WINDOW
                st.applied = {s for s in st.applied if s > horizon}
            st.frames += 1
            _FRAMES.labels(host, replica).inc()
            # trace deltas are append-only (the ring already forgot)
            tr = frame.get("trace") or {}
            st.trace.extend(tr.get("records") or ())
            st.thread_names.update(tr.get("thread_names") or {})
            skew = recv - float(frame.get("sent_at", recv))
            st.skew_last_s = skew
            st.skew_min_s = (skew if st.skew_min_s is None
                             else min(st.skew_min_s, skew))
            if seq > st.max_seq:
                # cumulative snapshots: only the newest wins — this IS
                # the exactly-once counter merge
                st.max_seq = seq
                if frame.get("metrics"):
                    st.metrics = frame["metrics"]
                st.health = frame.get("health") or st.health
                st.knobs = frame.get("knobs") or st.knobs
                st.flight_dir = frame.get("flight_dir") or st.flight_dir
                st.flight_index = tuple(frame.get("flight_index") or
                                        st.flight_index)
            self._dirty = True
        return outcome

    def ingest_dir(self, directory: str) -> int:
        """Drain a spool directory once (files not ingested before).
        Delivery order is the filename sort = (source, seq) order, but
        the seq protocol makes any order safe."""
        from deeplearning4j_tpu_torch.telemetry import export as export_mod

        with self._lock:
            seen = self._spools.setdefault(str(directory), set())
            paths = [p for p in export_mod.list_spooled(directory)
                     if p.split("/")[-1] not in seen]
            # claim before parsing so concurrent drains never double-read
            for p in paths:
                seen.add(p.split("/")[-1])
        n = 0
        for p in paths:
            try:
                with open(p) as f:
                    frame = json.load(f)
            except (OSError, ValueError):
                # a cross-host transfer need not be rename-atomic on the
                # reader's filesystem: unclaim so the next drain re-tries.
                # (source, seq) dedup makes an eventual double-read safe.
                with self._lock:
                    self._spools.setdefault(str(directory), set()).discard(
                        p.split("/")[-1])
                continue
            self.deliver(frame)
            n += 1
        return n

    def poll(self) -> int:
        """One pull tick: invoke every live source's puller, drain every
        attached spool. Rides the caller's cadence — no background thread
        ever runs."""
        with self._lock:
            pullers = [(st.key, st.puller) for st in self._sources.values()
                       if st.live and st.puller is not None]
            spools = list(self._spools)
        n = 0
        for _, pull in pullers:
            try:
                frame = pull()
            except Exception:
                continue  # a sick source must not sink the tick; its seq gap records the miss
            if frame:
                self.deliver(frame)
                n += 1
        for d in spools:
            n += self.ingest_dir(d)
        return n

    def finalize(self) -> None:
        """Flush the reorder grace window: every still-missing seq is
        declared dropped. End-of-drain / test determinism hook."""
        with self._lock:
            for st in self._sources.values():
                for s in list(st.missing):
                    del st.missing[s]
                    _DROPPED.labels(st.host, st.replica).inc()

    # -- merged metrics -----------------------------------------------
    def _rebuild_locked(self) -> None:
        reg = metrics_mod.MetricsRegistry()
        gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                     List[Tuple[str, float]]] = {}
        for st in self._sources.values():
            for name, fam in sorted(st.metrics.items()):
                labelnames = tuple(fam.get("labelnames") or ())
                # a source may itself run a collector (register_local_host
                # ships the process registry, fleet meters included), so a
                # family can already carry host/replica labels — appending
                # them again would emit duplicate label names, which is
                # invalid Prometheus exposition. Prefix the appended source
                # identity until it cannot collide.
                extra = ("host", "replica")
                while any(n in labelnames for n in extra):
                    extra = tuple(f"source_{n}" for n in extra)
                ext = labelnames + extra
                ftype = fam.get("type")
                try:
                    for series in fam.get("series") or ():
                        labels = series.get("labels") or {}
                        vals = tuple(str(labels.get(ln, ""))
                                     for ln in labelnames)
                        extvals = vals + (st.host, st.replica)
                        if ftype == "counter":
                            m = reg.counter(name, fam.get("help", ""), ext)
                            m.labels(*extvals).inc(float(series["value"]))
                        elif ftype == "gauge":
                            m = reg.gauge(name, fam.get("help", ""), ext)
                            m.labels(*extvals).set(float(series["value"]))
                            gkey = (name, tuple(zip(labelnames, vals)))
                            gauges.setdefault(gkey, []).append(
                                (fam.get("help", ""),
                                 float(series["value"])))
                        elif ftype == "histogram":
                            bounds = tuple(series.get("bounds") or ())
                            if not bounds:
                                continue
                            m = reg.histogram(name, fam.get("help", ""),
                                              ext, buckets=bounds)
                            m.labels(*extvals).merge_cumulative(
                                bounds, series.get("cumulative") or (),
                                series.get("sum", 0.0),
                                series.get("count", 0))
                except (ValueError, KeyError, TypeError):
                    _CONFLICTS.labels(name).inc()
        # fleet-level gauge aggregates: one <name>_fleet family with an
        # agg label per original label combination
        for (name, labelpairs), entries in sorted(gauges.items()):
            lns = tuple(k for k, _ in labelpairs) + ("agg",)
            vals = [v for _, v in entries]
            help_ = entries[0][0]
            try:
                m = reg.gauge(f"{name}_fleet",
                              f"{help_} (fleet aggregate)", lns)
                base = tuple(v for _, v in labelpairs)
                m.labels(*(base + ("min",))).set(min(vals))
                m.labels(*(base + ("max",))).set(max(vals))
                m.labels(*(base + ("sum",))).set(sum(vals))
            except ValueError:
                _CONFLICTS.labels(f"{name}_fleet").inc()
        self._registry = reg
        self._dirty = False

    def registry(self) -> metrics_mod.MetricsRegistry:
        """The merged fleet registry (rebuilt lazily after new frames).
        The federated SLO engine reads THIS, not the process one."""
        with self._lock:
            if self._dirty:
                self._rebuild_locked()
            return self._registry

    def render(self) -> str:
        """Prometheus exposition of the merged fleet."""
        return self.registry().render()

    # -- merged trace -------------------------------------------------
    def merged_chrome_trace(self) -> Dict[str, Any]:
        """ONE Chrome trace across every source: a lane group per host
        (synthetic pid + process_name), thread_name lanes kept, flows
        and trace_ids intact, per-source clock-skew stamped as drift
        metadata (process_labels + the top-level ``fleet`` block)."""
        with self._lock:
            sources = sorted(self._sources.values(),
                             key=lambda s: (s.host, s.replica))
        pid_for_host: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        meta: List[Dict[str, Any]] = []
        for st in sources:
            pid = pid_for_host.get(st.host)
            if pid is None:
                pid = pid_for_host[st.host] = len(pid_for_host) + 1
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "args": {"name": st.host}})
            skew = st.skew_min_s
            if skew is not None:
                events.append({
                    "name": "process_labels", "ph": "M", "pid": pid,
                    "args": {"labels": f"clock_skew[{st.replica}]="
                                       f"{skew * 1e3:+.3f}ms"}})
            for tid, label in sorted(st.thread_names.items()):
                try:
                    tid_i = int(tid)
                except ValueError:
                    continue
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid_i,
                               "args": {"name": label}})
            for rec in st.trace:
                events.append(_chrome_event(rec, pid))
            meta.append({
                "host": st.host, "replica": st.replica, "live": st.live,
                "frames": st.frames, "max_seq": st.max_seq,
                "clock_skew_s": skew,
                "clock_skew_last_s": st.skew_last_s,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "fleet": {"sources": meta}}

    # -- fleet SLO ----------------------------------------------------
    def slo_engine(self, rules: Optional[Sequence[Any]] = None):
        """The federated SLO engine, created on first use over the
        merged registry. Same grammar, different truth: burn that no
        single replica sees locally still crosses the fleet windows."""
        from deeplearning4j_tpu_torch.telemetry import slo as slo_mod

        with self._lock:
            if self._slo is None or rules is not None:
                self._slo = slo_mod.SloEngine(
                    rules if rules is not None else slo_mod.default_rules(),
                    registry=self.registry_if_fresh,
                    offending=self._offending_traces,
                    bundle_reason="fleet_slo_burn",
                    episode_extra=self._episode_extra)
            return self._slo

    def registry_if_fresh(self) -> metrics_mod.MetricsRegistry:
        return self.registry()

    def slo_tick(self, now: Optional[float] = None,
                 rules: Optional[Sequence[Any]] = None):
        """poll + federated sample/evaluate in one call."""
        self.poll()
        return self.slo_engine(rules).tick(now)

    def _offending_traces(self, limit: int = 20) -> List[str]:
        """Fleet twin of slo.offending_traces: scan MERGED records from
        every source for bad-outcome spans."""
        with self._lock:
            sources = list(self._sources.values())
        seen: Dict[str, None] = {}
        for st in sources:
            for rec in st.trace:
                args = dict(rec.get("attrs") or {})
                tid = rec.get("trace_id")
                if not tid or tid in seen:
                    continue
                outcome = args.get("outcome")
                if ((outcome is not None and outcome != "ok")
                        or "rejected" in args):
                    seen[tid] = None
                    if len(seen) >= limit:
                        return list(seen)
        return list(seen)

    def _episode_extra(self, episode: Dict[str, Any]) -> Dict[str, Any]:
        """Fleet episode bundle payload: the offending trace events
        JOINED across sources — the cross-host incident as one record."""
        wanted = set(episode.get("offending_traces") or ())
        joined: List[Dict[str, Any]] = []
        with self._lock:
            sources = list(self._sources.values())
        for st in sources:
            for rec in st.trace:
                if rec.get("trace_id") in wanted:
                    joined.append(dict(rec, host=st.host,
                                       replica=st.replica))
        return {"fleet": {
            "sources": [{"host": s.host, "replica": s.replica,
                         "frames": s.frames, "live": s.live}
                        for s in sources],
            "joined_trace_events": joined[:500],
        }}

    # -- read-only views ----------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            sources = sorted(self._sources.values(),
                             key=lambda s: (s.host, s.replica))
            return {
                "sources": [{
                    "host": s.host, "replica": s.replica, "live": s.live,
                    "frames": s.frames, "max_seq": s.max_seq,
                    "missing": len(s.missing),
                    "trace_records": len(s.trace),
                    "clock_skew_s": s.skew_min_s,
                    "health": (s.health or {}).get("status")
                    if isinstance(s.health, dict) else None,
                } for s in sources],
                "spools": list(self._spools),
            }


def _chrome_event(rec: Dict[str, Any], pid: int) -> Dict[str, Any]:
    """Frame record dict -> Chrome event under the source's lane group
    (mirrors SpanRecord.to_chrome, with the synthetic fleet pid)."""
    phase = rec.get("phase") or "X"
    ev: Dict[str, Any] = {
        "name": rec.get("name"),
        "cat": rec.get("category") or "default",
        "ph": phase,
        "ts": round(float(rec.get("start") or 0.0) * 1e6, 3),
        "pid": pid,
        "tid": rec.get("thread_id"),
    }
    if phase == "X":
        ev["dur"] = round(float(rec.get("duration_ms") or 0.0) * 1e3, 3)
    elif phase in ("s", "f"):
        ev["id"] = rec.get("flow_id")
        if phase == "f":
            ev["bp"] = "e"
    else:
        ev["s"] = "p"
    args = dict(rec.get("attrs") or {})
    if rec.get("trace_id") is not None:
        args["trace_id"] = rec["trace_id"]
        if rec.get("span_id") is not None:
            args["span_id"] = rec["span_id"]
        if rec.get("parent_id") is not None:
            args["parent_id"] = rec["parent_id"]
    if args:
        ev["args"] = args
    return ev


# ---------------------------------------------------------------------------
# process-global collector (gate-checked BEFORE any state exists)
# ---------------------------------------------------------------------------

_collector: Optional[FleetCollector] = None  # guarded-by: _collector_lock
_collector_lock = threading.Lock()


def collector() -> Optional[FleetCollector]:
    """The process collector, or None while the telemetry gate is off —
    the disabled path allocates nothing."""
    global _collector
    if not trace_mod.tracer().enabled:
        return None
    with _collector_lock:
        if _collector is None:
            _collector = FleetCollector()
        return _collector


def _current() -> Optional[FleetCollector]:
    """The collector if one already exists — gate-on readers don't
    allocate fleet state as a side effect of looking."""
    if not trace_mod.tracer().enabled:
        return None
    with _collector_lock:
        return _collector


def register_replica(replica_id: str, snapshot_fn: Callable[[], Dict[str, Any]],
                     host: Optional[str] = None) -> bool:
    """Autoscaler hook: make a replica a fleet source. Its frames are
    identity + per-replica gauges derived from the server's own
    ``snapshot()`` — NOT a second copy of the process registry, which
    all in-process replicas share (shipping it per replica would
    double-count every host counter). Returns False when the gate is
    off (nothing registered, nothing allocated)."""
    from deeplearning4j_tpu_torch.telemetry import export as export_mod

    c = collector()
    if c is None:
        return False
    reg = metrics_mod.MetricsRegistry()
    depth = reg.gauge("dl4j_tpu_replica_queue_depth",
                      "Replica queue depth (fleet source)")
    ema = reg.gauge("dl4j_tpu_replica_ema_latency_seconds",
                    "Replica EMA latency (fleet source)")
    exp = export_mod.FrameExporter(
        host=host, replica=str(replica_id), registry=reg)

    def pull() -> Optional[Dict[str, Any]]:
        try:
            snap = snapshot_fn() or {}
        except Exception:
            return None  # a draining replica may refuse a snapshot; its seq gap records the miss
        depth.set(float(snap.get("queue_depth", 0) or 0))
        ema.set(float(snap.get("ema_latency_s", 0) or 0))
        return exp.frame(include_trace=False)

    c.register_source(exp.host, str(replica_id), puller=pull)
    return True


def deregister_replica(replica_id: str, host: Optional[str] = None) -> None:
    """Autoscaler hook: drop a drained/evicted replica's puller (its
    merged history stays — see FleetCollector.deregister_source)."""
    from deeplearning4j_tpu_torch.telemetry import flight as flight_mod
    import socket

    c = _current()
    if c is None:
        return
    if host is None:
        idx = flight_mod.host_process_index()
        host = f"host{idx}" if idx is not None else socket.gethostname()
    c.deregister_source(host, str(replica_id))


def register_local_host() -> bool:
    """Make this process's full telemetry (registry + trace ring) a
    fleet source, pulled on every collector tick."""
    from deeplearning4j_tpu_torch.telemetry import export as export_mod

    c = collector()
    exp = export_mod.exporter()
    if c is None or exp is None:
        return False
    c.register_source(exp.host, exp.replica, puller=exp.frame)
    return True


def reset_for_tests() -> None:
    global _collector
    with _collector_lock:
        _collector = None
