"""Telemetry frames — the unit of fleet federation (counterpart of the
frame builder in deeplearning4j_tpu/telemetry/export.py).

A *frame* is one source's self-describing telemetry delta: the full
cumulative metrics state (typed, labeled, histogram bins included — the
exposition as data, so the collector can merge without re-parsing text),
the trace-ring delta since the last frame (``Tracer.records_since``
cursor seam), the health verdict, the knob snapshot, and an index of the
flight bundles on disk. Frames are sequence-numbered per source (1-based,
monotone) so the collector (telemetry/aggregate.py) can detect
re-delivery, loss, and reordering on whatever transport carried them — a
spool directory shared across processes, an in-process puller, or a test
calling ``ingest`` directly.

Metrics inside a frame are CUMULATIVE, not deltas: the collector keeps
only the highest-seq snapshot per source, which is what makes the
counter merge exactly-once by construction — a duplicated or reordered
frame can never double-count. Trace records ARE deltas (the ring
forgets), so those ride the cursor.

``sent_at`` is wall-clock seconds stamped at build time; the collector
compares it against its own receive wall-clock to estimate per-source
clock skew and stamps the estimate on the merged trace as drift
metadata — it never rewrites span timestamps.

The port has no HealthMonitor and no knob registry yet: a frame's
``health`` is None (as the JAX package's is while no monitor is live) and
its ``knobs`` are the env gates (telemetry/flight.py). The HTTP
endpoints that serve frames and the fleet are not part of the port yet.

Self-metering: every build observes
``dl4j_tpu_telemetry_frame_build_seconds`` and
``dl4j_tpu_telemetry_frame_bytes``.

Gate: ``DL4J_TPU_TELEMETRY``. ``exporter()`` returns None while the
gate is off — no exporter state, no frames, nothing allocated.
"""
from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.telemetry import flight as flight_mod
from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util import envflags

FRAME_VERSION = 1
SPOOL_GATE = "DL4J_TPU_FLEET_SPOOL"
_SPOOL_PREFIX = "frame_"

_BUILD_SECONDS = metrics_mod.histogram(
    "dl4j_tpu_telemetry_frame_build_seconds",
    "Telemetry frame build latency (federation self-overhead)",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0))
_FRAME_BYTES = metrics_mod.histogram(
    "dl4j_tpu_telemetry_frame_bytes",
    "Serialized telemetry frame size",
    buckets=(1024, 8192, 65536, 262144, 1048576, 8388608))

# frames must survive JSON: math.inf (histogram +Inf) never leaves
# bucket_counts trimmed below, and trace record fields are scalars


def build_latency_quantile(q: float = 0.5) -> Optional[float]:
    """Upper-bound estimate of the q-quantile of frame-build latency from
    the self-meter's buckets (the smallest bucket bound whose cumulative
    count covers q). None until at least one frame has been built."""
    total = _BUILD_SECONDS.count
    if not total:
        return None
    target = q * total
    for bound, cum in _BUILD_SECONDS.bucket_counts():
        if cum >= target:
            return bound
    return None


def _metric_state(m) -> Dict[str, Any]:
    """One family's cumulative state, typed and label-expanded."""
    out: Dict[str, Any] = {
        "type": m.typename,
        "help": m.help,
        "labelnames": list(m.labelnames),
        "series": [],
    }
    for labels, child in m.child_items():
        if m.typename == "histogram":
            pairs = child.bucket_counts()
            out["series"].append({
                "labels": labels,
                "bounds": [b for b, _ in pairs if not math.isinf(b)],
                "cumulative": [c for b, c in pairs if not math.isinf(b)],
                "sum": child.sum,
                "count": child.count,
            })
        else:
            out["series"].append({"labels": labels,
                                  "value": float(child.value)})
    return out


def _record_state(rec) -> Dict[str, Any]:
    """SpanRecord -> plain dict (every slot; attrs copied)."""
    return {
        "name": rec.name, "category": rec.category, "start": rec.start,
        "duration_ms": rec.duration_ms, "thread_id": rec.thread_id,
        "attrs": dict(rec.attrs) if rec.attrs else None,
        "phase": rec.phase, "trace_id": rec.trace_id,
        "span_id": rec.span_id, "parent_id": rec.parent_id,
        "flow_id": rec.flow_id,
    }


class FrameExporter:
    """Per-source frame builder: owns the source identity, the monotone
    ``seq`` counter, and the trace-ring cursor. One exporter per
    (host, replica) source; thread-safe — the autoscaler's evaluate
    tick and another reader may both pull frames."""

    def __init__(self, host: Optional[str] = None, replica: str = "-",
                 registry: Optional[metrics_mod.MetricsRegistry] = None,
                 tracer: Optional[trace_mod.Tracer] = None):
        idx = flight_mod.host_process_index()
        if host is None:
            host = f"host{idx}" if idx is not None else socket.gethostname()
        self.host = str(host)
        self.replica = str(replica)
        self._registry = registry  # None -> process-global at build time
        self._tracer = tracer
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: self._lock
        self._cursor = 0  # guarded-by: self._lock

    def _parts(self):
        reg = self._registry or metrics_mod.registry()
        tr = self._tracer or trace_mod.tracer()
        return reg, tr

    def frame(self, include_metrics: bool = True,
              include_trace: bool = True) -> Dict[str, Any]:
        """Build (and sequence-stamp) the next frame. Cheap relative to
        a scrape — one registry walk + the ring delta; both knobs exist
        so replica sources can ship identity-only heartbeats."""
        t0 = time.perf_counter()
        reg, tr = self._parts()
        recs: List[Any] = []
        gap = 0
        with self._lock:
            self._seq += 1
            seq = self._seq
            cursor = self._cursor
            if include_trace:
                # ring read + cursor advance are ONE atomic step: two
                # concurrent pulls (autoscaler tick + another reader) must
                # never ship the same ring records in two frames
                recs, cursor, gap = tr.records_since(cursor)
                self._cursor = cursor
        trace_delta: Dict[str, Any] = {"records": [], "cursor": cursor,
                                       "gap": 0, "thread_names": {}}
        if include_trace:
            trace_delta = {
                "records": [_record_state(r) for r in recs],
                "cursor": cursor,
                "gap": gap,
                "thread_names": {str(k): v
                                 for k, v in tr.thread_names().items()},
            }
        metrics_state: Dict[str, Any] = {}
        if include_metrics:
            metrics_state = {m.name: _metric_state(m)
                             for m in reg.families()}
        frame = {
            "frame_version": FRAME_VERSION,
            "source": {
                "host": self.host,
                "replica": self.replica,
                "pid": os.getpid(),
                "process_index": flight_mod.host_process_index(),
            },
            "seq": seq,
            "sent_at": time.time(),
            "metrics": metrics_state,
            "trace": trace_delta,
            "health": None,
            "knobs": flight_mod._knob_snapshot(),
            "flight_index": [os.path.basename(p)
                             for p in flight_mod.list_bundles()],
            "flight_dir": flight_mod.flight_dir(),
        }
        dt = time.perf_counter() - t0
        _BUILD_SECONDS.observe(dt)
        _FRAME_BYTES.observe(len(json.dumps(frame)))
        return frame

    def spool(self, directory: Optional[str] = None) -> str:
        """Build a frame and write it atomically into a spool directory
        (default ``DL4J_TPU_FLEET_SPOOL``) — the cross-process shipping
        path: each worker spools, the coordinator's collector drains with
        ``FleetCollector.ingest_dir``. Filenames
        sort by (source, seq) so drains replay in emit order."""
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            atomic_write_json,
        )

        d = directory or envflags.value(SPOOL_GATE)
        if not d:
            raise ValueError("no spool directory: pass one or set "
                             f"{SPOOL_GATE}")
        os.makedirs(d, exist_ok=True)
        frame = self.frame()
        path = os.path.join(
            d, f"{_SPOOL_PREFIX}{self.host}_{self.replica}_"
               f"{frame['seq']:08d}.json")
        atomic_write_json(path, frame)
        return path


def list_spooled(directory: str) -> List[str]:
    """Spooled frame paths, (source, seq)-ordered."""
    if not os.path.isdir(directory):
        return []
    return [os.path.join(directory, n) for n in sorted(os.listdir(directory))
            if n.startswith(_SPOOL_PREFIX) and n.endswith(".json")]


# ---------------------------------------------------------------------------
# process-global exporter (gate-checked BEFORE any state exists)
# ---------------------------------------------------------------------------

_exporter: Optional[FrameExporter] = None  # guarded-by: _exporter_lock
_exporter_lock = threading.Lock()


def exporter() -> Optional[FrameExporter]:
    """This process's host-level frame source, or None while the
    telemetry gate is off — the disabled path allocates nothing."""
    global _exporter
    if not trace_mod.tracer().enabled:
        return None
    with _exporter_lock:
        if _exporter is None:
            _exporter = FrameExporter()
        return _exporter


def reset_for_tests() -> None:
    global _exporter
    with _exporter_lock:
        _exporter = None
