"""SLO burn-rate engine — multi-window alerting over the MetricsRegistry
(counterpart of deeplearning4j_tpu/telemetry/slo.py: the same rules over
the same metric operations give the same status rows and episodes).

Google's SRE workbook alerting recipe, scaled down to a single training/
serving process: each ``SloRule`` states an objective (the good-event
fraction, e.g. 0.999 availability) over events the registry already
counts — there is NO new collection path, the engine only READS metrics
the hot paths tick anyway:

  * counter-ratio rules select bad/total events from labeled counter
    families (``Selector`` include/exclude label matching), e.g.
    serving availability = requests with ``outcome != ok`` over all
    resolved requests.
  * histogram-threshold rules count observations above a latency bound
    via ``Histogram.bucket_counts()`` (the Prometheus ``le`` series as
    data), e.g. "99% of requests under 250 ms".

``tick()`` snapshots the cumulative counts (one sample per call — the
engine is PULL-based: no background thread; the serving Router's
``evaluate()`` and tests drive it) and evaluates two rolling windows per rule:

  burn = (bad_delta / total_delta) / (1 - objective)

over a FAST window (default 60 s — catches a cliff in minutes of budget)
and a SLOW window (default 600 s — rides out blips). A window fires when
its burn crosses the rule's threshold (defaults 14 / 6, the workbook's
pairing); the ALERT needs both at once, which is what makes the pager
both fast and non-flappy. On each window's rising edge the engine ticks
``dl4j_tpu_slo_burn_alerts_total{slo,window}``; on the CONJUNCTION's
rising edge it opens one alert *episode*: emits an ``slo.burn`` trace
instant, and writes exactly ONE flight bundle (reason ``slo_burn``)
carrying the rule's burn numbers and the offending trace ids scraped
from the tracer ring (spans whose ``outcome``/``rejected`` args mark
them bad) — the bridge from "the SLO is burning" to "these requests
burned it". The episode closes when the conjunction stops firing; a
later rising edge is a NEW episode with its own bundle.

``healthz_section()`` is the health-payload merge hook (the HTTP
endpoints that serve it are not part of the port yet). Sample timestamps
come from ``time.perf_counter()`` (monotonic — an NTP step cannot stretch
or reorder a window) and every public entry point accepts an injectable
``now`` so tests pin episode counts deterministically.

Gate: ``DL4J_TPU_TELEMETRY``. With the gate off every entry point
returns its null value before touching (or creating) any engine state —
no samples, no threads, nothing allocated.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

_ALERTS = metrics_mod.counter(
    "dl4j_tpu_slo_burn_alerts_total",
    "SLO burn-rate window alerts (rising edges), by rule and window",
    labelnames=("slo", "window"))

_BAD_OUTCOME_ARGS = ("outcome", "rejected")


# ---------------------------------------------------------------------------
# rule grammar
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Selector:
    """One counter-family term: sum every series of ``metric`` whose
    labels pass ``include`` (label -> allowed values; absent = any) and
    ``exclude`` (label -> rejected values). A metric that is not
    registered yet contributes 0 — rules may be declared before the
    paths that tick their counters ever ran."""

    metric: str
    include: Optional[Dict[str, Sequence[str]]] = None
    exclude: Optional[Dict[str, Sequence[str]]] = None

    def read(self, registry=None) -> float:
        """Sum the family's matching series. ``registry`` defaults to
        the process-global one; the federated engine passes the fleet
        collector's merged registry (telemetry/aggregate.py) — same
        grammar, different truth."""
        m = (registry or metrics_mod.registry()).get(self.metric)
        if m is None:
            return 0.0
        total = 0.0
        for labels, child in m.child_items():
            if self.include and any(
                    labels.get(k) not in tuple(v)
                    for k, v in self.include.items()):
                continue
            if self.exclude and any(
                    labels.get(k) in tuple(v)
                    for k, v in self.exclude.items()):
                continue
            total += float(child.value)
        return total


@dataclass(frozen=True)
class SloRule:
    """One objective. Exactly one of the two evaluator shapes:

      counter-ratio        ``bad`` + ``total`` Selector tuples
      histogram-threshold  ``histogram`` (name) + ``threshold`` (same
                           unit as the buckets; observations ABOVE it
                           are the bad events, total = count).
                           ``histogram_include`` / ``histogram_exclude``
                           filter the family's children by labels with
                           Selector's semantics — the per-version
                           latency gate a canary rollout needs
                           (``dl4j_tpu_model_latency_seconds{model,
                           version}``, serving/router.py)
    """

    name: str
    objective: float                      # good fraction target, (0, 1)
    bad: Tuple[Selector, ...] = ()
    total: Tuple[Selector, ...] = ()
    histogram: Optional[str] = None
    threshold: Optional[float] = None
    histogram_include: Optional[Dict[str, Sequence[str]]] = None
    histogram_exclude: Optional[Dict[str, Sequence[str]]] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 14.0
    slow_burn: float = 6.0

    def __post_init__(self):
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"{self.name}: objective must be in (0, 1)")
        if self.histogram is not None:
            if self.threshold is None:
                raise ValueError(f"{self.name}: histogram rule needs a "
                                 f"threshold")
        elif not (self.bad and self.total):
            raise ValueError(f"{self.name}: counter rule needs bad AND "
                             f"total selectors")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def counts(self, registry=None) -> Tuple[float, float]:
        """Cumulative (bad, total) right now, from ``registry``
        (default: the process-global one)."""
        if self.histogram is not None:
            return self._histogram_counts(registry)
        return (sum(s.read(registry) for s in self.bad),
                sum(s.read(registry) for s in self.total))

    def _histogram_counts(self, registry=None) -> Tuple[float, float]:
        m = (registry or metrics_mod.registry()).get(self.histogram)
        if m is None:
            return 0.0, 0.0
        bad = total = 0.0
        for labels, child in m.child_items():
            if self.histogram_include and any(
                    labels.get(k) not in tuple(v)
                    for k, v in self.histogram_include.items()):
                continue
            if self.histogram_exclude and any(
                    labels.get(k) in tuple(v)
                    for k, v in self.histogram_exclude.items()):
                continue
            buckets = child.bucket_counts()
            count = buckets[-1][1]
            good = 0
            for bound, cum in buckets:
                if bound <= self.threshold:
                    good = cum
                else:
                    break
            total += count
            bad += count - good
        return bad, total


def default_rules() -> List[SloRule]:
    """The stock objectives over metrics the runtime already ticks."""
    requests = "dl4j_tpu_serving_requests_total"
    shed = "dl4j_tpu_serving_shed_total"
    return [
        # 99.9% of admitted requests resolve ok
        SloRule(name="serving_availability", objective=0.999,
                bad=(Selector(requests, exclude={"outcome": ("ok",)}),),
                total=(Selector(requests),)),
        # 99% of served requests complete under 250 ms
        SloRule(name="serving_latency", objective=0.99,
                histogram="dl4j_tpu_serving_latency_seconds",
                threshold=0.25),
        # 99% of optimizer steps finish under 1 s (dl4j_tpu_step_seconds,
        # which the training call sites tick once they carry telemetry)
        SloRule(name="step_time", objective=0.99,
                histogram="dl4j_tpu_step_seconds", threshold=1.0),
        # at most 1% of offered load shed before dispatch
        SloRule(name="serving_shed_rate", objective=0.99,
                bad=(Selector(shed),),
                total=(Selector(requests), Selector(shed))),
    ]


def version_rules(model: str, version: str,
                  availability_objective: float = 0.999,
                  latency_objective: float = 0.99,
                  latency_threshold_s: float = 0.25,
                  **windows) -> List[SloRule]:
    """Per-version availability + latency rules over the router's
    ``dl4j_tpu_model_requests_total{model,version,outcome}`` counter and
    ``dl4j_tpu_model_latency_seconds{model,version}`` histogram
    (serving/router.py) — the promotion gate of a canary rollout: one
    pair per (model, version), named ``serving_availability:m:v`` /
    ``serving_latency:m:v`` so status rows and alert labels read as
    the version they judge. ``windows`` forwards fast/slow window and
    burn overrides to both rules (rollout tests shrink them)."""
    requests = "dl4j_tpu_model_requests_total"
    include = {"model": (model,), "version": (version,)}
    return [
        SloRule(name=f"serving_availability:{model}:{version}",
                objective=availability_objective,
                bad=(Selector(requests, include=dict(include),
                              exclude={"outcome": ("ok",)}),),
                total=(Selector(requests, include=dict(include)),),
                **windows),
        SloRule(name=f"serving_latency:{model}:{version}",
                objective=latency_objective,
                histogram="dl4j_tpu_model_latency_seconds",
                threshold=latency_threshold_s,
                histogram_include=dict(include),
                **windows),
    ]


def tenant_rules(tenant: str,
                 availability_objective: float = 0.999,
                 latency_objective: float = 0.99,
                 latency_threshold_s: float = 0.25,
                 shed_objective: float = 0.99,
                 **windows) -> List[SloRule]:
    """Per-tenant SLO slice over serving/tenancy.py's ``{tenant}``-labeled
    metrics (``dl4j_tpu_tenant_requests_total{tenant,outcome}``,
    ``dl4j_tpu_tenant_latency_seconds{tenant}``,
    ``dl4j_tpu_tenant_shed_total{tenant,reason}``) — the isolation
    contract of the multi-tenant fleet: one tenant's burst can drive its
    OWN availability/shed rules into an episode while every other
    tenant's stay green. Named ``tenant_availability:t`` /
    ``tenant_latency:t`` / ``tenant_shed_rate:t`` so status rows and
    the Autoscaler's tenant gate read as the tenant they judge; ``windows``
    forwards fast/slow window and burn overrides to all three."""
    requests = "dl4j_tpu_tenant_requests_total"
    shed = "dl4j_tpu_tenant_shed_total"
    include = {"tenant": (tenant,)}
    return [
        SloRule(name=f"tenant_availability:{tenant}",
                objective=availability_objective,
                bad=(Selector(requests, include=dict(include),
                              exclude={"outcome": ("ok",)}),),
                total=(Selector(requests, include=dict(include)),),
                **windows),
        SloRule(name=f"tenant_latency:{tenant}",
                objective=latency_objective,
                histogram="dl4j_tpu_tenant_latency_seconds",
                threshold=latency_threshold_s,
                histogram_include=dict(include),
                **windows),
        SloRule(name=f"tenant_shed_rate:{tenant}",
                objective=shed_objective,
                bad=(Selector(shed, include=dict(include)),),
                total=(Selector(requests, include=dict(include)),
                       Selector(shed, include=dict(include))),
                **windows),
    ]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class _RuleState:
    samples: Deque[Tuple[float, float, float]] = field(default_factory=deque)
    firing_fast: bool = False
    firing_slow: bool = False
    episode_active: bool = False
    episodes: int = 0


class SloEngine:
    """Holds per-rule sample rings + alert state. Pull-driven: callers
    (the Router / tests) invoke ``tick``; nothing runs between
    calls and construction starts no threads."""

    def __init__(self, rules: Optional[Sequence[SloRule]] = None,
                 registry=None, offending=None,
                 bundle_reason: str = "slo_burn", episode_extra=None):
        """``registry`` — a MetricsRegistry or a zero-arg callable
        returning one (the fleet collector rebuilds its merged registry
        per tick, so the federated instance passes a callable); default
        is the process-global registry. ``offending`` — replaces the
        module's ``offending_traces`` scan for episode bundles (the
        fleet engine scans merged frames, not the local ring).
        ``bundle_reason``/``episode_extra`` shape the flight bundle a
        rising-edge episode writes (``fleet_slo_burn`` bundles join
        trace events across sources)."""
        self.rules: List[SloRule] = (  # guarded-by: self._lock
            list(rules) if rules is not None else default_rules())
        self._registry = registry
        self._offending = offending
        self._bundle_reason = bundle_reason
        self._episode_extra = episode_extra
        self._lock = threading.Lock()
        self._state: Dict[str, _RuleState] = {  # guarded-by: self._lock
            r.name: _RuleState() for r in self.rules}
        self._last_status: List[Dict[str, Any]] = []  # guarded-by: self._lock

    def _resolve_registry(self):
        reg = self._registry
        return reg() if callable(reg) else reg

    def add_rule(self, rule: SloRule) -> None:
        """Install one more rule on a live engine (the router adds
        per-version rules when a rollout starts). Replacing a rule of
        the same name resets its sample history — a new canary of the
        same version tag judges from a clean window."""
        with self._lock:
            self.rules = [r for r in self.rules if r.name != rule.name]
            self.rules.append(rule)
            self._state[rule.name] = _RuleState()

    def remove_rule(self, name: str) -> None:
        with self._lock:
            self.rules = [r for r in self.rules if r.name != name]
            self._state.pop(name, None)
            self._last_status = [row for row in self._last_status
                                 if row["slo"] != name]

    # -- sampling -----------------------------------------------------
    def sample(self, now: Optional[float] = None) -> None:
        """Snapshot each rule's cumulative (bad, total) at ``now``
        (perf-clock seconds; injectable for tests)."""
        t = time.perf_counter() if now is None else now
        reg = self._resolve_registry()
        with self._lock:
            for rule in self.rules:
                bad, total = rule.counts(reg)
                st = self._state[rule.name]
                st.samples.append((t, bad, total))
                horizon = t - rule.slow_window_s * 2.0
                while len(st.samples) > 2 and st.samples[1][0] < horizon:
                    st.samples.popleft()

    @staticmethod
    def _window_burn(rule: SloRule, st: _RuleState, window_s: float,
                     now: float) -> float:
        """Burn over [now - window_s, now]: delta against the newest
        sample at or before the window start (falling back to the
        oldest sample while history is shorter than the window)."""
        if len(st.samples) < 2:
            return 0.0
        t_now, bad_now, total_now = st.samples[-1]
        base = st.samples[0]
        cutoff = now - window_s
        for s in st.samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        d_total = total_now - base[2]
        if d_total <= 0:
            return 0.0
        d_bad = bad_now - base[1]
        return (d_bad / d_total) / rule.error_budget

    # -- evaluation ---------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Recompute burn/firing per rule over the stored samples;
        handle rising edges (alert counters, trace instant, ONE flight
        bundle per episode). Returns the status rows."""
        t = time.perf_counter() if now is None else now
        tr = trace_mod.tracer()
        episodes_opened: List[Tuple[SloRule, Dict[str, Any]]] = []
        status: List[Dict[str, Any]] = []
        with self._lock:
            for rule in self.rules:
                st = self._state[rule.name]
                burn_fast = self._window_burn(rule, st, rule.fast_window_s, t)
                burn_slow = self._window_burn(rule, st, rule.slow_window_s, t)
                fast = burn_fast >= rule.fast_burn
                slow = burn_slow >= rule.slow_burn
                if fast and not st.firing_fast:
                    _ALERTS.labels(rule.name, "fast").inc()
                if slow and not st.firing_slow:
                    _ALERTS.labels(rule.name, "slow").inc()
                st.firing_fast, st.firing_slow = fast, slow
                firing = fast and slow
                if firing and not st.episode_active:
                    st.episodes += 1
                    episodes_opened.append((rule, {
                        "rule": rule.name,
                        "objective": rule.objective,
                        "burn_fast": round(burn_fast, 3),
                        "burn_slow": round(burn_slow, 3),
                        "episode": st.episodes,
                    }))
                st.episode_active = firing
                bad, total = (st.samples[-1][1], st.samples[-1][2]) \
                    if st.samples else (0.0, 0.0)
                status.append({
                    "slo": rule.name,
                    "objective": rule.objective,
                    "bad": bad,
                    "total": total,
                    "burn_fast": round(burn_fast, 3),
                    "burn_slow": round(burn_slow, 3),
                    "firing_fast": fast,
                    "firing_slow": slow,
                    "firing": firing,
                    "episodes": st.episodes,
                })
            self._last_status = status
        # bundles outside the lock: flight.dump re-enters telemetry
        for rule, episode in episodes_opened:
            self._open_episode(tr, episode)
        return status

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """sample + evaluate — the one call sites use."""
        self.sample(now)
        return self.evaluate(now)

    def _open_episode(self, tr, episode: Dict[str, Any]) -> None:
        from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

        offending = (self._offending or offending_traces)()
        episode = dict(episode, offending_traces=offending)
        tr.add_instant(self._bundle_reason.replace("_burn", ".burn"),
                       category="slo", **{
            k: v for k, v in episode.items() if k != "offending_traces"})
        extra: Dict[str, Any] = {"slo": episode}
        if self._episode_extra is not None:
            try:
                extra.update(self._episode_extra(episode))
            except Exception:
                pass  # the bundle must land even if the extra hook is sick
        flight_mod.dump(self._bundle_reason, note=episode["rule"],
                        extra=extra)

    # -- read-only views ---------------------------------------------
    def status(self) -> List[Dict[str, Any]]:
        """Last evaluation's rows (empty before the first tick)."""
        with self._lock:
            return list(self._last_status)

    def firing(self) -> List[str]:
        with self._lock:
            return [row["slo"] for row in self._last_status
                    if row["firing"]]

    def episode_counts(self) -> Dict[str, int]:
        with self._lock:
            return {name: st.episodes for name, st in self._state.items()}


def offending_traces(limit: int = 20) -> List[str]:
    """Trace ids of bad-outcome spans currently in the tracer ring —
    spans whose args carry a trace_id plus a non-ok ``outcome`` or a
    ``rejected`` reason. Ordered oldest-first, deduped, capped."""
    events = trace_mod.tracer().to_chrome_trace().get("traceEvents", [])
    seen: Dict[str, None] = {}
    for ev in events:
        args = ev.get("args") or {}
        tid = args.get("trace_id")
        if not tid or tid in seen:
            continue
        outcome = args.get("outcome")
        if (outcome is not None and outcome != "ok") or "rejected" in args:
            seen[tid] = None
            if len(seen) >= limit:
                break
    return list(seen)


# ---------------------------------------------------------------------------
# module-level entry points (gate-checked BEFORE any engine state exists)
# ---------------------------------------------------------------------------

_engine: Optional[SloEngine] = None  # guarded-by: _engine_lock
_engine_lock = threading.Lock()


def engine() -> Optional[SloEngine]:
    """The process engine, or None while the telemetry gate is off —
    the disabled path allocates nothing."""
    global _engine
    if not trace_mod.tracer().enabled:
        return None
    with _engine_lock:
        if _engine is None:
            _engine = SloEngine()
        return _engine


def _current() -> Optional[SloEngine]:
    """The engine if one already exists — unlike ``engine()`` this never
    creates one, so gate-on readers (/healthz, ``status()``) don't
    allocate SLO state as a side effect of looking."""
    if not trace_mod.tracer().enabled:
        return None
    with _engine_lock:
        return _engine


def configure(rules: Sequence[SloRule]) -> Optional[SloEngine]:
    """Replace the engine's rules (tests / embedders). Gated like
    ``engine()``; returns the fresh engine or None when disabled."""
    global _engine
    if not trace_mod.tracer().enabled:
        return None
    with _engine_lock:
        _engine = SloEngine(rules)
        return _engine


def tick(now: Optional[float] = None) -> Optional[List[Dict[str, Any]]]:
    eng = engine()
    return None if eng is None else eng.tick(now)


def status() -> List[Dict[str, Any]]:
    eng = _current()
    return [] if eng is None else eng.status()


def healthz_section() -> Optional[Dict[str, Any]]:
    """Health-payload merge hook: None while gated off or never ticked."""
    eng = _current()
    if eng is None:
        return None
    rows = eng.status()
    if not rows:
        return None
    return {"firing": [r["slo"] for r in rows if r["firing"]],
            "episodes": eng.episode_counts()}


def render_status(rows: List[Dict[str, Any]]) -> str:
    """Human table of status rows (what the JAX package's ``slo`` CLI
    prints)."""
    if not rows:
        return "no SLO status (telemetry gate off, or no ticks yet)"
    lines = [f"{'slo':<22} {'objective':>9} {'bad':>8} {'total':>8} "
             f"{'burn_fast':>9} {'burn_slow':>9} {'firing':>6} {'ep':>3}"]
    for r in rows:
        lines.append(
            f"{r['slo']:<22} {r['objective']:>9} {r['bad']:>8.0f} "
            f"{r['total']:>8.0f} {r['burn_fast']:>9.2f} "
            f"{r['burn_slow']:>9.2f} "
            f"{'FIRING' if r['firing'] else '-':>6} {r['episodes']:>3}")
    return "\n".join(lines)


def reset_for_tests() -> None:
    global _engine
    with _engine_lock:
        _engine = None
