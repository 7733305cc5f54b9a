"""Black-box flight recorder — postmortem bundles (counterpart of
deeplearning4j_tpu/telemetry/flight.py; the bundle's keys and
``BUNDLE_VERSION`` are the JAX package's, so each package's
``load_bundle`` and ``summarize`` read the other's bundles).

The ring buffer and metrics registry die with the process; this module
writes them to disk at the moment something goes wrong, so a broken
breaker, a rolled-back canary or a crashed replica leaves a
self-contained artifact instead of a blank terminal. One bundle = one
JSON file under ``DL4J_TPU_FLIGHT_DIR`` (default: a per-user directory
under the temp dir) holding:

  * the Chrome trace of the last-N spans (the tracer's ring buffer,
    Perfetto-ready)
  * the full metrics snapshot (every counter/gauge/histogram)
  * the exception type/message/traceback (when one exists)
  * the health section: the port has no HealthMonitor yet (the training
    call sites carry none), so it is the JAX package's payload for a
    process whose monitor never saw a heartbeat, and the input-pipeline
    verdict is None
  * every DL4J_TPU_* env gate in effect (``env``), and the same gates
    under ``knobs`` — the JAX package records its knob registry's
    effective values there, and the port has no knob registry yet
  * the runtime: ``torch.distributed``'s rank and world size when a
    process group is up (else process 0 of 1) and the names of the
    ``torch.cuda`` devices
  * ``analyzer_estimates``: None — the port has no model analyzer yet
    (the JAX package also writes None when it cannot analyse a model)
  * the latest checkpoint manifest when a CheckpointManager is known

Callers: the serving breaker (``serving_breaker``), the router's
rollback (``canary_rollback``), the SLO engine's episodes
(``slo_burn``), membership evictions (``eviction``), the autoscaler's
spawn-failure episodes (``replica_spawn``) and the lock-order sentinel
(``lock_inversion``). Writes are atomic — tmp + fsync + rename through
resilience/checkpoint.py's ``atomic_write_json`` — so a crash mid-dump
can never leave a torn bundle. The directory is bounded:
``DL4J_TPU_FLIGHT_KEEP`` (default 20) prunes the oldest bundles after
each dump (0 disables rotation). ``install_faulthandler`` points the
stdlib faulthandler at the same directory, so even a fatal signal leaves
a readable stack artifact.

Gate: ``DL4J_TPU_TELEMETRY``. With the gate off, ``dump`` returns None
immediately and allocates nothing.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import traceback as traceback_mod
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.telemetry import context as context_mod
from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util import envflags

logger = logging.getLogger("deeplearning4j_tpu_torch")

FLIGHT_DIR_GATE = "DL4J_TPU_FLIGHT_DIR"
FLIGHT_KEEP_GATE = "DL4J_TPU_FLIGHT_KEEP"
DEFAULT_KEEP = 20
BUNDLE_VERSION = 1
BUNDLE_PREFIX = "flight_"
# the JAX package's health payload for a process whose monitor never saw
# a heartbeat: what the port reports until it has a HealthMonitor
NO_HEARTBEAT = {"ok": False, "reason": "no heartbeat yet (no telemetry-"
                                       "enabled fit has completed a step)"}

_DUMPS = metrics_mod.counter(
    "dl4j_tpu_flight_dumps_total",
    "Flight-recorder bundles written, by trigger", labelnames=("reason",))

_seq_lock = threading.Lock()
_seq = 0  # guarded-by: _seq_lock


def flight_dir() -> str:
    """DL4J_TPU_FLIGHT_DIR, defaulting to a stable per-user tempdir —
    a crash artifact must land somewhere writable even when nobody
    configured the recorder, and must never silently litter the CWD."""
    d = envflags.value(FLIGHT_DIR_GATE)
    if d:
        return d
    return os.path.join(tempfile.gettempdir(),
                        f"dl4j-tpu-flight-{os.getuid()}"
                        if hasattr(os, "getuid") else "dl4j-tpu-flight")


def enabled() -> bool:
    return trace_mod.tracer().enabled


# ---------------------------------------------------------------------------
# bundle assembly
# ---------------------------------------------------------------------------


def _env_gates() -> Dict[str, str]:
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("DL4J_TPU_")}


def _knob_snapshot() -> Dict[str, Any]:
    """The knob section: the JAX package records its knob registry's
    effective values with provenance here; the port has no knob registry
    yet, so the section holds the env gates alone."""
    return _env_gates()


def host_process_index() -> Optional[int]:
    """The rank of this process when a ``torch.distributed`` process group
    with more than one rank is up — None otherwise, so single-process
    artifacts don't grow a misleading always-0 host field. Guarded:
    stamping an artifact must never break (or start) anything."""
    try:
        import torch.distributed as dist

        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return int(dist.get_rank())
    except Exception:
        pass  # the stamp must never break the dump
    return None


def _runtime_section() -> Optional[Dict[str, Any]]:
    """The distributed runtime as ``torch.distributed`` and ``torch.cuda``
    see it, under the JAX package's keys; guarded like the host stamp."""
    try:
        import torch
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        rank = int(dist.get_rank()) if up else 0
        world = int(dist.get_world_size()) if up else 1
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = ([torch.cuda.get_device_name(i) for i in range(n)]
                 if n else ["cpu"])
        return {
            "process_index": rank,
            "process_count": world,
            "local_devices": local,
            "global_device_count": len(local) * world,
        }
    except Exception:
        return None


def _checkpoint_section(checkpoint_manager) -> Optional[dict]:
    """The newest manifest — what a resume would restore from."""
    if checkpoint_manager is None:
        return None
    try:
        manifests = checkpoint_manager.manifests()
        return manifests[-1] if manifests else None
    except Exception:
        return None


def _exception_section(exc: Optional[BaseException]) -> Optional[dict]:
    if exc is None:
        return None
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "traceback": "".join(traceback_mod.format_exception(
            type(exc), exc, exc.__traceback__)),
    }


def build_bundle(reason: str, exc: Optional[BaseException] = None,
                 model=None, checkpoint_manager=None,
                 note: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble (but do not write) one postmortem bundle dict.

    ``trace_id`` is the ACTIVE TraceContext's trace id at dump time (None
    when nothing is active) — the correlation hook: `postmortem --trace
    <id>` joins a bundle back to the exact request/fit whose death wrote
    it. ``extra`` (e.g. the SLO engine's episode record) is merged as
    top-level keys; reserved keys are never overwritten by it. ``model``
    is accepted for the JAX signature; its analyzer section is None (see
    the module docstring)."""
    bundle = {
        "bundle_version": BUNDLE_VERSION,
        "reason": reason,
        "note": note,
        "time": time.time(),  # a pure timestamp, never subtracted
        "pid": os.getpid(),
        "process_index": host_process_index(),
        "trace_id": context_mod.current_trace_id(),
        "exception": _exception_section(exc),
        "health": dict(NO_HEARTBEAT),
        "input_pipeline": None,
        "trace": trace_mod.tracer().to_chrome_trace(),
        "metrics": metrics_mod.registry().snapshot(),
        "env": _env_gates(),
        "knobs": _knob_snapshot(),
        "runtime": _runtime_section(),
        "analyzer_estimates": None,
        "checkpoint": _checkpoint_section(checkpoint_manager),
    }
    if extra:
        for k, v in extra.items():
            bundle.setdefault(k, v)
    return bundle


def dump(reason: str, exc: Optional[BaseException] = None, model=None,
         checkpoint_manager=None, note: Optional[str] = None,
         extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Atomically write one bundle under DL4J_TPU_FLIGHT_DIR and return
    its path. No-op (None) when telemetry is disabled. Never raises — a
    failing black box must not mask the crash it is recording."""
    global _seq
    if not trace_mod.tracer().enabled:
        return None
    try:
        from deeplearning4j_tpu_torch.resilience.checkpoint import atomic_write_json

        bundle = build_bundle(reason, exc=exc, model=model,
                              checkpoint_manager=checkpoint_manager,
                              note=note, extra=extra)
        d = flight_dir()
        os.makedirs(d, exist_ok=True)
        with _seq_lock:
            _seq += 1
            n = _seq
        path = os.path.join(
            d, f"{BUNDLE_PREFIX}{int(bundle['time'] * 1e3)}_"
               f"{os.getpid()}_{n:03d}_{reason}.json")
        atomic_write_json(path, bundle)
        _DUMPS.labels(reason).inc()
        _rotate(d)
        logger.warning("flight-recorder bundle written: %s (%s)", path,
                       reason)
        return path
    except Exception:
        logger.exception("flight-recorder dump failed (reason=%s)", reason)
        return None


def _rotate(directory: str) -> None:
    """Prune oldest bundles past DL4J_TPU_FLIGHT_KEEP (default 20; 0 or
    negative disables rotation). Chaos suites write a bundle per
    injected fault — without a cap the flight dir grows without bound
    across runs. Bundle filenames sort by write time (ms timestamp
    prefix), so lexicographic oldest-first IS chronological; the
    faulthandler logs are not bundles and are never touched. Best-effort
    like everything else in the black box: a file another process
    already pruned is skipped, never an error."""
    keep = envflags.int_value(FLIGHT_KEEP_GATE, DEFAULT_KEEP)
    if keep <= 0:
        return
    bundles = list_bundles(directory)
    for path in bundles[:max(0, len(bundles) - keep)]:
        try:
            os.remove(path)
        except OSError:
            continue


def record_crash(exc: BaseException, model=None, checkpoint_manager=None,
                 phase: Optional[str] = None) -> Optional[str]:
    """An exception hook: one bundle per escaping exception (the JAX
    package's fit paths call it; the port's training call sites do not
    carry telemetry yet). Gated + guarded exactly like ``dump``."""
    return dump("exception", exc=exc, model=model,
                checkpoint_manager=checkpoint_manager, note=phase)


# ---------------------------------------------------------------------------
# faulthandler: the below-Python layer of the black box
# ---------------------------------------------------------------------------

_fh_path: Optional[str] = None
_fh_file = None


def install_faulthandler() -> Optional[str]:
    """Point the stdlib faulthandler at ``<flight dir>/faulthandler_<pid>.log``
    so SIGSEGV/SIGABRT/deadlocked-interpreter stacks land next to the
    bundles. Installed once per process, only while telemetry is enabled;
    returns the log path (or None when gated off / unwritable)."""
    global _fh_path, _fh_file
    if not trace_mod.tracer().enabled:
        return None
    if _fh_path is not None:
        return _fh_path
    try:
        import atexit
        import faulthandler

        d = flight_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"faulthandler_{os.getpid()}.log")
        f = open(path, "w")
        faulthandler.enable(file=f)
        _fh_file, _fh_path = f, path
        # the log must stay open for the process lifetime (faulthandler
        # writes to the raw fd on a fatal signal); close it only at
        # orderly interpreter exit so shutdown doesn't warn about it
        atexit.register(_close_faulthandler)
        return path
    except Exception:  # never let the black box break the plane
        return None


def _close_faulthandler() -> None:
    global _fh_file
    if _fh_file is None:
        return
    try:
        import faulthandler

        faulthandler.disable()
        _fh_file.close()
    except Exception:  # orderly-exit cleanup only; never raise
        return
    _fh_file = None


def _reset_faulthandler_for_tests() -> None:
    global _fh_path
    _close_faulthandler()
    _fh_path = None


# ---------------------------------------------------------------------------
# inspection (what the JAX package's `postmortem` CLI prints)
# ---------------------------------------------------------------------------


def list_bundles(directory: Optional[str] = None) -> List[str]:
    """Bundle paths under the flight dir, oldest first."""
    d = directory or flight_dir()
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, name) for name in sorted(os.listdir(d))
            if name.startswith(BUNDLE_PREFIX) and name.endswith(".json")]


def load_bundle(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _phase_table(bundle: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Per-phase duration stats over the bundle's embedded Chrome trace,
    rendered through the Tracer.summary() schema."""
    events = (bundle.get("trace") or {}).get("traceEvents") or []
    t = trace_mod.Tracer(capacity=max(1, len(events)), enabled=True)
    for ev in events:
        if ev.get("ph") == "X" and "dur" in ev:
            t.add_span(str(ev.get("name")), float(ev["dur"]) / 1e3,
                       category=str(ev.get("cat") or ""))
    return t.summary()


def summarize(bundle: Dict[str, Any]) -> str:
    """Human one-screen rendering of a bundle."""
    lines = [
        f"flight bundle v{bundle.get('bundle_version')}  "
        f"reason={bundle.get('reason')}  pid={bundle.get('pid')}",
        f"time: {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(bundle.get('time', 0)))}",
    ]
    if bundle.get("note"):
        lines.append(f"note: {bundle['note']}")
    health = bundle.get("health") or {}
    if health:
        lines.append(
            f"health: ok={health.get('ok')}  phase={health.get('phase')}  "
            f"iteration={health.get('iteration')}  "
            f"stalls={health.get('stalls', 0)}")
    ip = bundle.get("input_pipeline") or {}
    if ip.get("verdict"):
        lines.append(
            f"input pipeline: {ip['verdict']}  (etl p50 "
            f"{ip.get('etl_p50_ms')} ms vs step p50 "
            f"{ip.get('step_p50_ms')} ms, queue depth p50 "
            f"{ip.get('queue_depth_p50')})")
    exc = bundle.get("exception")
    if exc:
        lines.append(f"exception: {exc.get('type')}: {exc.get('message')}")
        tb = (exc.get("traceback") or "").rstrip().splitlines()
        lines.extend("  " + t for t in tb[-6:])
    ckpt = bundle.get("checkpoint")
    if ckpt:
        lines.append(
            f"latest checkpoint: step {ckpt.get('step')}  epoch "
            f"{ckpt.get('epoch')}  score {ckpt.get('score')}")
    phases = _phase_table(bundle)
    if phases:
        lines.append(f"{'phase':<24} {'count':>7} {'total_ms':>12} "
                     f"{'p50_ms':>10}")
        for name, s in phases.items():
            lines.append(f"{name:<24} {s['count']:>7} "
                         f"{s['total_ms']:>12.1f} {s['p50_ms']:>10.2f}")
    stragglers = (health.get("stragglers") or {})
    laggards = {k: v for k, v in stragglers.items() if v and v > 1.5}
    if laggards:
        lines.append("stragglers: " + ", ".join(
            f"{k} ({v:.2f}x)" for k, v in sorted(laggards.items())))
    return "\n".join(lines)
