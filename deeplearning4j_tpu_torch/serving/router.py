"""Router — model-name dispatch + SLO-gated canary rollout (counterpart
of deeplearning4j_tpu/serving/router.py: the same requests split the same
way, and roll back or promote on the same tick, in both packages).

The fleet's front door: ``output(model, x)`` routes on model name into
the registry's per-version InferenceServers, and a versioned rollout
splits one model's traffic between ``v_stable`` and ``v_canary`` along a
configurable ramp (default 5 → 25 → 50 → 100%). The SLO burn-rate engine
(telemetry/slo.py) is the promotion gate:

  per-version SLOs   every routed request ticks
                     ``dl4j_tpu_model_requests_total{model,version,
                     outcome}`` and (successes) observes
                     ``dl4j_tpu_model_latency_seconds{model,version}``;
                     ``slo.version_rules`` turns those into
                     ``serving_availability:m:v`` /
                     ``serving_latency:m:v`` rules installed on the
                     router's SloEngine when a rollout starts.
  the ramp           deterministic counter-based splitting (request n
                     goes canary iff ``floor(n·f)`` advanced — exact
                     fractions, no RNG to seed), one stage at a time:
                     each ``evaluate()`` tick may advance the ramp only
                     after ``min_requests`` canary requests landed in
                     the current stage with no rule firing.
  auto-rollback      a burn-rate episode on EITHER canary rule rolls
                     back inside that same evaluation tick: traffic
                     snaps to 100% stable, the ramp freezes, the canary
                     chaos points disarm, exactly ONE
                     ``canary_rollback`` flight bundle is written with
                     the offending trace ids, and
                     ``dl4j_tpu_canary_transitions_total{stage}`` ticks
                     ``rollback``. A fault-free canary that clears the
                     last stage promotes: it becomes the entry's stable
                     version (``promote`` transition).

``evaluate()`` is pull-driven like the SLO engine itself — the caller (a
control loop, a test) drives it; nothing runs between calls and every
entry point takes an injectable ``now``. A model may instead route
through an elastic replica pool (``attach_autoscaler``,
serving/autoscaler.py): ``output`` then round-robins the pool with tenant
passthrough and ``evaluate()`` drives the pool's scaling tick on the same
cadence. Pools and RUNNING rollouts are mutually exclusive per model — a
ramp splits traffic by version, a pool replicates one version.

Chaos: a deliberately-broken canary is one env var away —
``DL4J_TPU_CHAOS=canary_dispatch@1:2:3`` (raises in the canary's batch
dispatch) or ``canary_nan@...`` (non-finite outputs); both points are
armed only while the version is the active canary
(serving/registry.py), so the stable path is provably untouched.

The JAX router also gives the closed-loop tuner a tick per evaluation
while ``DL4J_TPU_AUTOTUNE`` is on. The tuner is not ported yet (ROADMAP
A.11): with the gate off ``evaluate`` does nothing for it, as in JAX;
with it on ``evaluate`` raises NotImplementedError rather than skip it.
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.serving.errors import (
    CircuitOpenError,
    DeadlineExceededError,
    DispatchFailedError,
    NonFiniteOutputError,
    ShedError,
    TenantQuotaError,
)
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry, ModelVersion
from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.telemetry import slo as slo_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util import envflags

AUTOTUNE_GATE = "DL4J_TPU_AUTOTUNE"
DEFAULT_STAGES = (0.05, 0.25, 0.50, 1.0)

_MODEL_REQUESTS = metrics_mod.counter(
    "dl4j_tpu_model_requests_total",
    "Routed requests resolved, by model, version, and outcome",
    labelnames=("model", "version", "outcome"))
_MODEL_LATENCY = metrics_mod.histogram(
    "dl4j_tpu_model_latency_seconds",
    "End-to-end routed request latency by model and version, successes "
    "only",
    labelnames=("model", "version"),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0))
_CANARY_TRANSITIONS = metrics_mod.counter(
    "dl4j_tpu_canary_transitions_total",
    "Canary rollout stage transitions (stage = ramp percent, 'promote', "
    "or 'rollback')",
    labelnames=("stage",))
_CANARY_FRACTION = metrics_mod.gauge(
    "dl4j_tpu_canary_traffic_fraction",
    "Current canary traffic fraction per model (0 when no rollout runs)",
    labelnames=("model",))

# live routers for models_section (weak — the serving/runtime.py pattern)
_ROUTERS: "weakref.WeakSet[Router]" = weakref.WeakSet()


def _outcome_of(exc: BaseException) -> str:
    """The per-version outcome label for a failed routed request —
    matches the runtime's outcome vocabulary so one Grafana legend
    covers both metric families."""
    if isinstance(exc, NonFiniteOutputError):
        return "nonfinite"
    if isinstance(exc, DispatchFailedError):
        return "dispatch_error"
    if isinstance(exc, DeadlineExceededError):
        return "deadline"
    if isinstance(exc, CircuitOpenError):
        return "breaker_open"
    if isinstance(exc, TenantQuotaError):
        return "tenant_quota"
    if isinstance(exc, ShedError):
        return "shed"
    return type(exc).__name__


class Rollout:
    """One model's in-flight (or finished) canary rollout."""

    RUNNING = "running"
    ROLLED_BACK = "rolled_back"
    PROMOTED = "promoted"

    def __init__(self, model: str, stable: str, canary: str,
                 stages: Sequence[float], min_requests: int):
        if not stages or any(not (0.0 < f <= 1.0) for f in stages):
            raise ValueError("stages must be fractions in (0, 1]")
        self.model = model
        self.stable = stable
        self.canary = canary
        self.stages = tuple(float(f) for f in stages)
        self.min_requests = max(1, int(min_requests))
        self.stage = 0
        self.state = self.RUNNING
        self.canary_requests_in_stage = 0
        self.rollback_bundle: Optional[str] = None
        self.rollback_rules: List[str] = []
        self.history: List[str] = [self._stage_label()]

    def _stage_label(self) -> str:
        return str(int(round(self.stages[self.stage] * 100)))

    @property
    def fraction(self) -> float:
        return self.stages[self.stage] if self.state == self.RUNNING \
            else 0.0

    def status(self) -> Dict[str, Any]:
        return {
            "model": self.model,
            "stable": self.stable,
            "canary": self.canary,
            "state": self.state,
            "stage": self.stage,
            "stages": [int(round(f * 100)) for f in self.stages],
            "fraction": self.fraction,
            "canary_requests_in_stage": self.canary_requests_in_stage,
            "min_requests": self.min_requests,
            "history": list(self.history),
            "rollback_bundle": self.rollback_bundle,
            "rollback_rules": list(self.rollback_rules),
        }


class Router:
    """Front door over a ModelRegistry. Owns (or borrows) an SloEngine
    whose per-version rules gate every ramp advance."""

    def __init__(self, registry: ModelRegistry,
                 slo_engine: Optional[slo_mod.SloEngine] = None):
        self.registry = registry
        # a dedicated engine with NO stock rules: the router only ever
        # judges the per-version rules it installs itself (the module
        # engine keeps judging the fleet-wide defaults independently)
        self.slo = slo_engine or slo_mod.SloEngine(rules=[])
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}  # guarded-by: self._lock
        self._rollouts: Dict[str, Rollout] = {}  # guarded-by: self._lock
        self._autoscalers: Dict[str, Any] = {}  # guarded-by: self._lock
        _ROUTERS.add(self)

    # ------------------------------------------------------------------
    # elastic pools
    # ------------------------------------------------------------------
    def attach_autoscaler(self, model: str, autoscaler) -> None:
        """Put an Autoscaler pool (serving/autoscaler.py) behind a model
        name: ``output(model, ...)`` round-robins over the pool's
        replicas and ``evaluate()`` drives its scaling tick. Mutually
        exclusive with a RUNNING canary rollout — a ramp splits traffic
        by version, a pool replicates ONE version; layering both would
        make the ramp's exact counter-split unaccountable."""
        self.registry.entry(model)  # KeyError on unknown model
        with self._lock:
            ro = self._rollouts.get(model)
            if ro is not None and ro.state == Rollout.RUNNING:
                raise ValueError(
                    f"model {model!r} has a running rollout "
                    f"({ro.canary}); finish it before attaching a pool")
            self._autoscalers[model] = autoscaler

    def detach_autoscaler(self, model: str):
        with self._lock:
            return self._autoscalers.pop(model, None)

    def autoscaler(self, model: str):
        with self._lock:
            return self._autoscalers.get(model)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _pick(self, model: str) -> ModelVersion:
        """Stable or canary for this request: the counter-based split —
        request n routes canary iff floor(n·f) advanced over
        floor((n-1)·f), which realizes fraction f exactly (a 5% stage
        sends request 20, 40, ... to the canary, no RNG)."""
        entry = self.registry.entry(model)
        with self._lock:
            ro = self._rollouts.get(model)
            f = ro.fraction if ro is not None else 0.0
            if f <= 0.0:
                return entry.stable_version()
            n = self._counts.get(model, 0) + 1
            self._counts[model] = n
            take_canary = math.floor(n * f) > math.floor((n - 1) * f)
            if take_canary:
                ro.canary_requests_in_stage += 1
                return entry.versions[ro.canary]
            return entry.stable_version()

    def output(self, model: str, x, deadline_s: Optional[float] = None,
               tenant: Optional[str] = None):
        """Blocking routed inference. Every resolution — success or
        typed failure — feeds the per-version SLO selectors; the
        underlying server's own fleet-wide metrics tick as before. A
        model with an attached Autoscaler routes through the pool
        (tenant admission and replica failover happen there)."""
        with self._lock:
            pool = self._autoscalers.get(model)
        if pool is not None:
            version = pool.version
            t0 = time.perf_counter()
            try:
                out = pool.output(x, deadline_s=deadline_s, tenant=tenant)
            except BaseException as e:
                _MODEL_REQUESTS.labels(model, version,
                                       _outcome_of(e)).inc()
                raise
            _MODEL_REQUESTS.labels(model, version, "ok").inc()
            _MODEL_LATENCY.labels(model, version).observe(
                time.perf_counter() - t0)
            return out
        mv = self._pick(model)
        t0 = time.perf_counter()
        try:
            out = mv.server.output(x, deadline_s=deadline_s,
                                   tenant=tenant)
        except BaseException as e:
            _MODEL_REQUESTS.labels(model, mv.version, _outcome_of(e)).inc()
            raise
        _MODEL_REQUESTS.labels(model, mv.version, "ok").inc()
        _MODEL_LATENCY.labels(model, mv.version).observe(
            time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------------
    # rollout lifecycle
    # ------------------------------------------------------------------
    def start_rollout(self, model: str, canary_version: str,
                      stages: Sequence[float] = DEFAULT_STAGES,
                      min_requests: int = 20,
                      **rule_kwargs) -> Rollout:
        """Begin ramping ``canary_version`` against the model's stable
        version. Installs per-version SLO rules for BOTH versions (the
        stable side's rows make a regression-by-comparison readable in the
        status rows) and arms the canary chaos points. ``rule_kwargs`` forward
        to ``slo.version_rules`` (tests shrink windows/thresholds)."""
        entry = self.registry.entry(model)
        stable = entry.stable
        if stable is None:
            raise ValueError(f"model {model!r} has no stable version to "
                             f"roll against")
        if canary_version == stable:
            raise ValueError(f"canary {canary_version!r} is already the "
                             f"stable version")
        canary_mv = self.registry.get(model, canary_version)
        with self._lock:
            existing = self._rollouts.get(model)
            if existing is not None and existing.state == Rollout.RUNNING:
                raise ValueError(f"model {model!r} already has a running "
                                 f"rollout ({existing.canary})")
            if model in self._autoscalers:
                raise ValueError(
                    f"model {model!r} routes through an autoscaled pool; "
                    f"detach it before starting a rollout")
            ro = Rollout(model, stable, canary_version, stages,
                         min_requests)
            self._rollouts[model] = ro
        for version in (stable, canary_version):
            for rule in slo_mod.version_rules(model, version,
                                              **rule_kwargs):
                self.slo.add_rule(rule)
        canary_mv.canary = True
        _CANARY_FRACTION.labels(model).set(ro.fraction)
        _CANARY_TRANSITIONS.labels(ro.history[0]).inc()
        trace_mod.tracer().add_instant(
            "canary.start", category="serving", model=model,
            canary=canary_version, fraction=ro.fraction)
        return ro

    def _canary_rule_names(self, ro: Rollout) -> List[str]:
        suffix = f":{ro.model}:{ro.canary}"
        return [r.name for r in self.slo.rules if r.name.endswith(suffix)]

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One SLO tick + one ramp decision per running rollout:
        rollback on a firing canary rule (same tick), else advance when
        the stage soaked ``min_requests`` canary requests, promoting off
        the final stage. Returns the engine's status rows."""
        rows = self.slo.tick(now)
        by_name = {row["slo"]: row for row in rows}
        with self._lock:
            running = [ro for ro in self._rollouts.values()
                       if ro.state == Rollout.RUNNING]
            pools = list(self._autoscalers.values())
        for pool in pools:  # attached fleets share the pull cadence
            pool.evaluate(now)
        self._tuner_tick(now)
        for ro in running:
            firing = [name for name in self._canary_rule_names(ro)
                      if by_name.get(name, {}).get("firing")]
            if firing:
                self._rollback(ro, firing, by_name)
            elif ro.canary_requests_in_stage >= ro.min_requests:
                self._advance(ro)
        return rows

    def _tuner_tick(self, now: Optional[float] = None) -> None:
        """The JAX router's closed-loop tuner tick (one controller tick,
        then a bucket re-cut evaluation per registered version). A no-op
        while ``DL4J_TPU_AUTOTUNE`` is off, as in JAX; the tuner is not
        ported yet, so with the gate on this raises instead of skipping
        the tick silently."""
        if envflags.enabled(AUTOTUNE_GATE, False):
            raise NotImplementedError(
                f"{AUTOTUNE_GATE} is on, but the closed-loop tuner "
                f"(telemetry/tuner.py and tuning/*, with the knob registry) "
                f"is not ported yet (ROADMAP A.11); unset the gate")

    def _advance(self, ro: Rollout) -> None:
        if ro.stage + 1 < len(ro.stages):
            ro.stage += 1
            ro.canary_requests_in_stage = 0
            label = ro._stage_label()
            ro.history.append(label)
            _CANARY_TRANSITIONS.labels(label).inc()
            _CANARY_FRACTION.labels(ro.model).set(ro.fraction)
            trace_mod.tracer().add_instant(
                "canary.advance", category="serving", model=ro.model,
                canary=ro.canary, fraction=ro.fraction)
        else:
            self._promote(ro)

    def _promote(self, ro: Rollout) -> None:
        ro.state = Rollout.PROMOTED
        ro.history.append("promote")
        self.registry.get(ro.model, ro.canary).canary = False
        self.registry.set_stable(ro.model, ro.canary)
        _CANARY_TRANSITIONS.labels("promote").inc()
        _CANARY_FRACTION.labels(ro.model).set(0.0)
        trace_mod.tracer().add_instant(
            "canary.promote", category="serving", model=ro.model,
            canary=ro.canary)

    def _rollback(self, ro: Rollout, firing: List[str],
                  by_name: Dict[str, Dict[str, Any]]) -> None:
        """Snap to 100% stable inside the detecting tick. The ramp
        freezes (state ROLLED_BACK: fraction pins to 0 and evaluate
        never advances it again); the incident record is ONE
        ``canary_rollback`` flight bundle carrying the firing rules'
        burn numbers and the offending trace ids scraped from the
        tracer ring."""
        from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

        ro.state = Rollout.ROLLED_BACK
        ro.rollback_rules = list(firing)
        ro.history.append("rollback")
        self.registry.get(ro.model, ro.canary).canary = False
        _CANARY_TRANSITIONS.labels("rollback").inc()
        _CANARY_FRACTION.labels(ro.model).set(0.0)
        offending = slo_mod.offending_traces()
        trace_mod.tracer().add_instant(
            "canary.rollback", category="serving", model=ro.model,
            canary=ro.canary, rules=",".join(firing))
        ro.rollback_bundle = flight_mod.dump(
            "canary_rollback", note=f"{ro.model}:{ro.canary}",
            extra={"canary": {
                "model": ro.model,
                "stable": ro.stable,
                "canary": ro.canary,
                "stage": ro.stage,
                "stage_percent": int(round(ro.stages[ro.stage] * 100)),
                "rules": [by_name[n] for n in firing if n in by_name],
                "offending_traces": offending,
            }})

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def rollout_status(self, model: Optional[str] = None
                       ) -> List[Dict[str, Any]]:
        with self._lock:
            ros = ([self._rollouts[model]] if model in self._rollouts
                   else [] if model is not None
                   else list(self._rollouts.values()))
        return [ro.status() for ro in ros]

    def snapshot(self) -> Dict[str, Any]:
        """Registry + rollout state (the JAX package's /models payload)."""
        snap = self.registry.snapshot()
        snap["rollouts"] = self.rollout_status()
        snap["slo"] = self.slo.status()
        with self._lock:
            pools = dict(self._autoscalers)
        if pools:
            snap["fleets"] = {model: pool.snapshot()
                              for model, pool in pools.items()}
        return snap


def models_section() -> Optional[Dict[str, Any]]:
    """The models payload over every live router (falling back to bare
    registries that have no router yet); None when the fleet layer was
    never constructed, keeping training-only processes' payloads
    unchanged (the serving/runtime.py healthz contract)."""
    from deeplearning4j_tpu_torch.serving.registry import live_registries

    routers = list(_ROUTERS)
    if routers:
        if len(routers) == 1:
            return routers[0].snapshot()
        return {"routers": [r.snapshot() for r in routers]}
    regs = live_registries()
    if not regs:
        return None
    if len(regs) == 1:
        return regs[0].snapshot()
    return {"registries": [r.snapshot() for r in regs]}
