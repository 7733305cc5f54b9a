"""Health telemetry, in part (counterpart of
deeplearning4j_tpu/telemetry/health.py).

What is here: the module's metrics under the JAX package's names (the
stall, straggler-skew and prefetch-queue families, and the
elastic-membership transitions and gauges), the two gates' readers
(``stall_timeout_s``: ``DL4J_TPU_STALL_TIMEOUT``, ``straggler_ratio``:
``DL4J_TPU_STRAGGLER_RATIO``) and ``observe_membership_transition``, which
distributed/membership.py calls on every transition.

What is not here yet: ``HealthMonitor`` with its stall watchdog and
straggler pass, ``fit_health``, ``healthz``, ``input_verdict``, ``live``
and ``monitor``. They serve the training call sites (the fit loops'
heartbeats, the prefetch iterators' queue accounting), which do not carry
telemetry in the port yet; nothing in the port calls them. Until they
come, a flight bundle's health section is the JAX package's payload for a
monitor that never saw a heartbeat (telemetry/flight.py).
"""
from __future__ import annotations

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
