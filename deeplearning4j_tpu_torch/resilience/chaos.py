"""Deterministic fault injection — recovery must be provable, not asserted
(counterpart of deeplearning4j_tpu/resilience/chaos.py: the same
``DL4J_TPU_CHAOS`` spec fires on the same calls in both packages).

Two injection surfaces:

1. `ChaosDataSetIterator` — wraps any DataSetIterator and, at seeded global
   batch indices, either raises ChaosError (a torn data fetch) or emits a
   NaN-features batch (the classic divergence trigger). Indices are 1-based
   counts over every batch the wrapper ever yields (monotonic across epochs
   and resets), so a given schedule reproduces exactly.

2. `fault_point(name)` — env-gated fault sites in production code paths.
   Inert unless the `DL4J_TPU_CHAOS` gate is set (read through
   util/envflags.py). Grammar — comma-separated clauses:

       DL4J_TPU_CHAOS=serving_dispatch@1,canary_nan@3:5

   Each clause is `point@hits` where `hits` is a `:`-separated list of
   1-based invocation counts at which that named point fires. Counts
   advance even on the firing invocation, so a retried operation passes
   on its next attempt — one gate value proves a whole fail-then-recover
   arc. `reset_fault_points()` zeroes the counters AND drops the cached
   spec parse (tests re-arm between cases; a test that flips
   `DL4J_TPU_CHAOS` to a value seen earlier must re-parse, not reuse a
   stale schedule).

   Raising points model crashes; SILENT points (`silent_fault`) model a
   component that stays alive but misbehaves without raising. Silent
   firings are metrics-counted distinctly (`<point>.silent`).

Fault points in the port:

    rejoin            distributed/membership.py, at each rejoin barrier
                      admission — a returning worker's first barrier
                      fails; jittered backoff must retry it
    serving_dispatch  serving/runtime.py, before each coalesced batch
                      dispatch — the dispatch raises; consecutive
                      firings must open the circuit breaker
    serving_slow      serving/runtime.py (SILENT) — dispatch sleeps
                      `slow_fault_s` first; deadlines must expire with a
                      typed error, not a hung caller
    serving_nan       serving/runtime.py (SILENT) — outputs replaced
                      with NaN; the non-finite check must discard the
                      result and trip the breaker
    canary_dispatch   serving/registry.py, before the ACTIVE CANARY
                      version's batch dispatch (armed only while
                      ModelVersion.canary is set — stable traffic and
                      warmups never consume the schedule); the router's
                      SLO gate must roll the canary back, never promote
    canary_nan        serving/registry.py (SILENT) — the active canary's
                      outputs replaced with NaN; the per-version
                      availability SLO must burn and trigger rollback
    replica_spawn     serving/autoscaler.py, at each replica factory
                      call — a scale-out spawn fails; the pool must
                      retry on later evaluate ticks with decorrelated
                      backoff and write ONE flight bundle per failure
                      episode (the rising edge), not one per attempt
    frame_drop        telemetry/aggregate.py (SILENT), at the fleet
                      collector's deliver() transport boundary — each
                      firing cycles drop -> duplicate -> reorder of one
                      telemetry frame
    tenant_burst      serving/tenancy.py (SILENT) — the firing
                      admission's token cost is amplified 10x; the noisy
                      tenant's OWN sub-queue must shed (typed
                      TenantQuotaError) while quiet tenants stay flat

The JAX package's training-side points (checkpoint_write, collective,
host_loss, heartbeat_drop, publish) come with the training call sites
(ROADMAP A.11).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Set, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.util import envflags

CHAOS_GATE = "DL4J_TPU_CHAOS"

# every injected fault is counted by site, so a chaos run's /metrics shows
# exactly which arcs were exercised (docs/TELEMETRY.md)
_INJECTIONS = metrics_mod.counter(
    "dl4j_tpu_chaos_injections_total",
    "Faults injected, by fault-point / iterator site",
    labelnames=("point",))


class ChaosError(IOError):
    """Injected fault. Subclasses IOError so production retry paths
    (retry_on=(OSError,)) treat it exactly like a real torn IO."""


# ---------------------------------------------------------------------------
# env-gated fault points
# ---------------------------------------------------------------------------

_counters: Dict[str, int] = {}  # guarded-by: _counter_lock
# fault points sit on genuinely concurrent paths (replica dispatchers and
# admission threads hit them at the same instant); an unsynchronized
# read-modify-write could double-assign a count and skip a scheduled
# firing — the lock keeps the injection schedule deterministic
_counter_lock = threading.Lock()
_parse_cache: Tuple[Optional[str], Dict[str, Set[int]]] = (None, {})


def _parse_spec(raw: str) -> Dict[str, Set[int]]:
    out: Dict[str, Set[int]] = {}
    for clause in raw.split(","):
        clause = clause.strip()
        if not clause or "@" not in clause:
            continue
        name, _, hits = clause.partition("@")
        steps = set()
        for h in hits.split(":"):
            try:
                steps.add(int(h))
            except ValueError:
                # garbage hit indices read as never-firing, not as 0 (the
                # envflags garbage-tolerance contract)
                pass
        if name.strip() and steps:
            out[name.strip()] = steps
    return out


def _spec() -> Dict[str, Set[int]]:
    global _parse_cache
    raw = envflags.value(CHAOS_GATE)
    if raw != _parse_cache[0]:
        _parse_cache = (raw, _parse_spec(raw) if raw else {})
    return _parse_cache[1]


def _should_fire(name: str) -> Optional[int]:
    """Advance the named point's invocation counter; return the count when
    the schedule says THIS invocation fails, else None."""
    spec = _spec()
    if not spec:
        return None
    hits = spec.get(name)
    if hits is None:
        return None
    with _counter_lock:
        _counters[name] = count = _counters.get(name, 0) + 1
    return count if count in hits else None


def fault_point(name: str) -> None:
    """Raise ChaosError when the DL4J_TPU_CHAOS schedule says this
    invocation of the named point should fail; otherwise no-op. Cheap when
    the gate is unset (one dict lookup after the cached parse)."""
    count = _should_fire(name)
    if count is not None:
        _INJECTIONS.labels(name).inc()
        raise ChaosError(
            f"chaos fault point '{name}' fired (invocation {count}; "
            f"schedule {sorted(_spec()[name])})")


def silent_fault(name: str) -> bool:
    """The non-raising twin of `fault_point` for faults whose whole point
    is that nothing raises — a worker that goes silent (`heartbeat_drop`)
    looks exactly like a slow one until the failure detector decides.
    Returns True when the schedule fires this invocation; the call site
    then SIMULATES the silence (stops heartbeating, parks) instead of
    crashing. Counted distinctly from raising injections under
    ``point="<name>.silent"`` so a chaos run's /metrics shows which arcs
    were silence vs crash."""
    count = _should_fire(name)
    if count is None:
        return False
    _INJECTIONS.labels(f"{name}.silent").inc()
    return True


def reset_fault_points() -> None:
    """Zero the per-point invocation counters AND drop the cached
    DL4J_TPU_CHAOS parse (test re-arm). Without the cache drop, a test
    that changes the gate between cases and back to an earlier value
    would reuse the stale parse — same raw string, different intent."""
    global _parse_cache
    with _counter_lock:
        _counters.clear()
        _parse_cache = (None, {})


# ---------------------------------------------------------------------------
# chaos iterator
# ---------------------------------------------------------------------------


class ChaosDataSetIterator(DataSetIterator):
    """Wrap an iterator with a deterministic fault schedule.

        it = ChaosDataSetIterator(base, nan_at=(3,), fail_at=(7,))

    Batch counting is 1-based and monotonic across epochs/resets: the 3rd
    batch ever yielded has NaN features (labels untouched — the loss goes
    NaN, the divergence-sentry trigger), and the 7th fetch raises
    ChaosError instead of yielding. A failed fetch consumes its index, so
    re-iterating continues past the fault — the retry-visible behavior of
    a transient data-source outage."""

    def __init__(self, underlying: DataSetIterator,
                 nan_at: Iterable[int] = (),
                 fail_at: Iterable[int] = ()):
        self.underlying = underlying
        self.nan_at = frozenset(int(i) for i in nan_at)
        self.fail_at = frozenset(int(i) for i in fail_at)
        self.count = 0  # batches ever pulled, never reset

    def reset(self):
        self.underlying.reset()

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        ds = next(self.underlying)
        self.count += 1
        if self.count in self.fail_at:
            _INJECTIONS.labels("iterator_fail").inc()
            raise ChaosError(
                f"chaos iterator fault at batch {self.count}")
        if self.count in self.nan_at:
            _INJECTIONS.labels("iterator_nan").inc()
            feats = (torch.full_like(ds.features.float(), float("nan"))
                     if isinstance(ds.features, torch.Tensor) else
                     np.full_like(np.asarray(ds.features, dtype=np.float32),
                                  np.nan))
            ds = DataSet(feats, ds.labels, ds.features_mask, ds.labels_mask)
        return ds

    def batch_size(self):
        return self.underlying.batch_size()

    def total_outcomes(self):
        return self.underlying.total_outcomes()

    def input_columns(self):
        return self.underlying.input_columns()

    def async_supported(self) -> bool:
        # faults must surface synchronously in the training loop, not from
        # a prefetch thread half a buffer later
        return False
