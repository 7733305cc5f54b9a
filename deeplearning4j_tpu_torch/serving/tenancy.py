"""Multi-tenant admission and weighted-fair queueing for the serving fleet
(counterpart of deeplearning4j_tpu/serving/tenancy.py).

One InferenceServer (or an Autoscaler pool) hosts many callers; without
isolation, one tenant's burst sheds everyone — the queue is shared, the
shed policy is blind to who filled it. This module gives each tenant:

  token-bucket quota   `TenancyController.admit(tenant, rows)` runs in
                       front of the shared queue: each tenant owns a
                       bucket refilled at `rate` rows/s up to `burst`
                       rows. An exhausted bucket raises TenantQuotaError
                       (a ShedError subclass, so `submit_with_retry`
                       backs off on its `retry_after_s` — the bucket's
                       refill horizon) and the shared queue never sees
                       the request: the bursting tenant sheds ITSELF.
  weighted-fair queue  `TenantQueue` replaces the server's FIFO deque
                       with per-tenant sub-queues drained by deficit
                       round-robin at coalesce time: each tenant's
                       deficit grows by `quantum * weight` rows per
                       round-robin visit and shrinks by the rows it
                       dispatches, so a backlogged tenant cannot starve
                       the others — long-run throughput is proportional
                       to weight, FIFO within a tenant. The queue is
                       deque-compatible (append/popleft/peek/remove) so
                       runtime.py's admission, expiry and drain paths
                       work unchanged; its state is guarded by the
                       owning server's Condition, like the deque it
                       replaces.
  per-tenant SLO slice telemetry carries `{tenant}` labels
                       (`dl4j_tpu_tenant_requests_total{tenant,outcome}`,
                       `dl4j_tpu_tenant_shed_total{tenant,reason}`,
                       `dl4j_tpu_tenant_latency_seconds{tenant}`) that
                       `slo.tenant_rules(tenant)` turns into burn-rate
                       rules, so one tenant's availability/latency
                       objective can fire while the others stay green.

Chaos fault point (resilience/chaos.py grammar):

    tenant_burst  SILENT: the firing admission's token cost is amplified
                  BURST_FACTOR (10x) — the noisy tenant's bucket drains,
                  so its later requests shed with TenantQuotaError while
                  the quiet tenants' p99 and shed rate stay flat.

Time comes from the controller's `clock` (time.monotonic by default), so
tests drive a fake clock.

Pure control-plane: no tensors, no threads. The controller's own lock never
nests inside itself and is only ever taken AFTER the server's Condition
(weight lookup at enqueue), never before — no lock-order cycle.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.serving.errors import TenantQuotaError
from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod
from deeplearning4j_tpu_torch.util.locks import TrackedLock

DEFAULT_TENANT = "default"
# tenant_burst chaos: one firing admission costs 10x its rows — "a tenant
# offered 10x its quota" compressed into one amplified take
BURST_FACTOR = 10

_TENANT_REQUESTS = metrics_mod.counter(
    "dl4j_tpu_tenant_requests_total",
    "Per-tenant admitted requests resolved, by outcome",
    labelnames=("tenant", "outcome"))
_TENANT_SHED = metrics_mod.counter(
    "dl4j_tpu_tenant_shed_total",
    "Per-tenant requests shed before the shared queue, by reason",
    labelnames=("tenant", "reason"))
_TENANT_LATENCY = metrics_mod.histogram(
    "dl4j_tpu_tenant_latency_seconds",
    "Per-tenant end-to-end request latency, successes only",
    labelnames=("tenant",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0))


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's share: `rate` rows/s refill up to `burst` rows of
    credit; `weight` scales its deficit-round-robin quantum."""

    name: str
    rate: float
    burst: float
    weight: float = 1.0


class TokenBucket:
    """Rows-per-second token bucket; all calls under the controller lock."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = now

    def take(self, cost: float, now: float) -> float:
        """Refill, then spend `cost` tokens. Returns 0.0 on success or
        the seconds until the bucket could cover `cost` (nothing spent)."""
        if now > self.stamp:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = max(self.stamp, now)
        if self.tokens >= cost:
            self.tokens -= cost
            return 0.0
        if cost > self.burst and self.tokens >= self.burst:
            # a cost the bucket can never fully hold (an amplified
            # tenant_burst take, or rows > burst) admits at full credit and
            # DRAINS it — the burst is paid for by the tenant's own
            # followers, which now shed. Without the spend this branch
            # would admit for free in a loop
            self.tokens = 0.0
            return 0.0
        if self.rate <= 0:
            return float("inf")
        # the hint is when the bucket could have covered min(cost, burst),
        # the most credit it can ever hold
        return (min(cost, self.burst) - self.tokens) / self.rate


class TenancyController:
    """Per-tenant quotas + observations shared by every server that takes
    it.

    Tenants auto-register on first sight with the default policy;
    `add_tenant` pins an explicit one. Thread-safe behind its own
    TrackedLock — admission runs on caller threads, observations on the
    dispatcher thread, snapshots on any thread.
    """

    def __init__(self, default_rate: float = 64.0,
                 default_burst: Optional[float] = None,
                 default_weight: float = 1.0,
                 quantum: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.default_rate = float(default_rate)
        self.default_burst = float(default_burst if default_burst is not None
                                   else 2 * default_rate)
        self.default_weight = float(default_weight)
        self.quantum = max(1, int(quantum))
        self._clock = clock
        self._lock = TrackedLock("serving.tenancy.controller")
        self._policies: Dict[str, TenantPolicy] = {}  # guarded-by: self._lock
        self._buckets: Dict[str, TokenBucket] = {}  # guarded-by: self._lock
        self._admitted: Dict[str, int] = {}  # guarded-by: self._lock
        self._sheds: Dict[str, int] = {}  # guarded-by: self._lock
        self._lat: Dict[str, deque] = {}  # guarded-by: self._lock

    # ---- policy ----
    def add_tenant(self, name: str, rate: Optional[float] = None,
                   burst: Optional[float] = None,
                   weight: Optional[float] = None) -> TenantPolicy:
        pol = TenantPolicy(
            name=name,
            rate=float(rate if rate is not None else self.default_rate),
            burst=float(burst if burst is not None else
                        (2 * rate if rate is not None else self.default_burst)),
            weight=float(weight if weight is not None else
                         self.default_weight))
        with self._lock:
            self._policies[name] = pol
            self._buckets[name] = TokenBucket(pol.rate, pol.burst,
                                              self._clock())
        return pol

    def _policy_locked(self, name: str) -> TenantPolicy:
        pol = self._policies.get(name)
        if pol is None:
            pol = TenantPolicy(name=name, rate=self.default_rate,
                               burst=self.default_burst,
                               weight=self.default_weight)
            self._policies[name] = pol
            self._buckets[name] = TokenBucket(pol.rate, pol.burst,
                                              self._clock())
        return pol

    def weight(self, name: str) -> float:
        with self._lock:
            return self._policy_locked(name).weight

    # ---- admission ----
    def admit(self, tenant: Optional[str], rows: int = 1) -> str:
        """Spend `rows` tokens from the tenant's bucket or raise
        TenantQuotaError with the refill horizon. Returns the resolved
        tenant name (None -> DEFAULT_TENANT)."""
        tenant = tenant or DEFAULT_TENANT
        # the chaos read happens OUTSIDE the lock: fault points never run
        # under a held lock
        cost = float(rows)
        if chaos.silent_fault("tenant_burst"):
            cost *= BURST_FACTOR
        now = self._clock()
        with self._lock:
            pol = self._policy_locked(tenant)
            wait = self._buckets[tenant].take(cost, now)
            if wait <= 0.0:
                self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
            else:
                self._sheds[tenant] = self._sheds.get(tenant, 0) + 1
        if wait > 0.0:
            _TENANT_SHED.labels(tenant, "quota").inc()
            raise TenantQuotaError(
                f"tenant {tenant!r} over quota ({pol.rate:g} rows/s, "
                f"burst {pol.burst:g}); retry in {wait:.3g}s",
                retry_after_s=wait, tenant=tenant)
        return tenant

    # ---- observations (dispatcher thread) ----
    def observe(self, tenant: str, outcome: str,
                latency_s: Optional[float] = None) -> None:
        """One resolved request of `tenant`; a served one (`latency_s`
        given) joins the tenant's latency ring."""
        _TENANT_REQUESTS.labels(tenant, outcome).inc()
        if latency_s is None:
            return
        _TENANT_LATENCY.labels(tenant).observe(latency_s)
        with self._lock:
            ring = self._lat.get(tenant)
            if ring is None:
                ring = deque(maxlen=256)
                self._lat[tenant] = ring
            ring.append(latency_s)

    def note_shed(self, tenant: Optional[str], reason: str) -> None:
        """A shared-queue shed attributed to a tenant (drop_oldest victim,
        queue_full, drain) — quota sheds tick inside admit()."""
        _TENANT_SHED.labels(tenant or DEFAULT_TENANT, reason).inc()

    # ---- queue + snapshot ----
    def make_queue(self, queue_limit: int) -> "TenantQueue":
        """The server's `_q` replacement; `queue_limit` bounds each
        sub-queue (the shared limit is enforced at admission, the maxlen
        is the belt)."""
        return TenantQueue(self, self.quantum, queue_limit)

    def snapshot(self) -> dict:
        def pct(vals: List[float], q: float) -> Optional[float]:
            if not vals:
                return None
            return vals[min(len(vals) - 1, int(q * (len(vals) - 1)))]

        with self._lock:
            rows = {}
            for name, pol in sorted(self._policies.items()):
                lat = sorted(self._lat.get(name, ()))
                rows[name] = {
                    "rate": pol.rate,
                    "burst": pol.burst,
                    "weight": pol.weight,
                    "tokens": round(self._buckets[name].tokens, 3),
                    "admitted": self._admitted.get(name, 0),
                    "shed": self._sheds.get(name, 0),
                    "latency_p50_s": (round(pct(lat, 0.5), 6)
                                      if lat else None),
                    "latency_p99_s": (round(pct(lat, 0.99), 6)
                                      if lat else None),
                }
        return {"quantum": self.quantum, "tenants": rows}


class TenantQueue:
    """Deficit-round-robin multi-queue, deque-compatible where runtime.py
    needs it: `append`, `popleft`, `q[0]` (peeks exactly what popleft
    would return), `remove`, `clear`, `len`, iteration, truthiness.

    NOT internally locked: it replaces InferenceServer's `_q` and every
    access already happens under that server's Condition, exactly like
    the plain deque it substitutes. The DRR cursor/deficit advance only
    on committed pops, so peek-then-pop under one lock hold is stable.
    """

    def __init__(self, ctrl: TenancyController, quantum: int,
                 queue_limit: int):
        self._ctrl = ctrl
        self._quantum = max(1, int(quantum))
        self._maxlen = max(1, int(queue_limit))
        self._subq: "OrderedDict[str, deque]" = OrderedDict()
        self._weights: Dict[str, float] = {}
        self._deficit: Dict[str, float] = {}
        self._order: List[str] = []
        self._cursor = 0
        # True while the cursor tenant has NOT yet been granted its
        # quantum on this visit: the grant happens exactly once per
        # round-robin arrival, which is what makes service proportional
        # to weight instead of to backlog
        self._fresh = True
        self._len = 0

    # ---- deque surface ----
    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self) -> Iterator:
        for q in self._subq.values():
            yield from q

    def __getitem__(self, idx):
        if idx != 0:
            raise IndexError("TenantQueue only peeks its DRR head")
        head = self._select(commit=False)
        if head is None:
            raise IndexError("peek from an empty TenantQueue")
        return head

    def append(self, req) -> None:
        tenant = getattr(req, "tenant", None) or DEFAULT_TENANT
        q = self._subq.get(tenant)
        if q is None:
            # belt only: admission enforces the shared queue_limit, so a
            # sub-queue can never actually reach maxlen and silently drop
            q = deque(maxlen=self._maxlen)
            self._subq[tenant] = q
            self._weights[tenant] = self._ctrl.weight(tenant)
            self._deficit[tenant] = 0.0
            self._order.append(tenant)
        q.append(req)
        self._len += 1

    def popleft(self):
        head = self._select(commit=True)
        if head is None:
            raise IndexError("pop from an empty TenantQueue")
        return head

    def remove(self, req) -> None:
        tenant = getattr(req, "tenant", None) or DEFAULT_TENANT
        q = self._subq.get(tenant)
        if q is not None:
            try:
                q.remove(req)
            except ValueError:
                pass  # falls through to the scan of every sub-queue
            else:
                self._len -= 1
                return
        # a caller-side expiry can race the default-tenant fallback:
        # scan every sub-queue before mirroring deque.remove's ValueError
        for q in self._subq.values():
            try:
                q.remove(req)
            except ValueError:
                continue
            self._len -= 1
            return
        raise ValueError("request not queued")

    def clear(self) -> None:
        for q in self._subq.values():
            q.clear()
        for t in self._deficit:
            self._deficit[t] = 0.0
        self._len = 0

    # ---- DRR core ----
    def _select(self, commit: bool):
        """The next request under deficit round-robin: arriving at a
        tenant grants `quantum * weight` rows of deficit ONCE, the
        tenant serves heads while the deficit covers them, then the
        cursor moves on (idle tenants forfeit their deficit). With
        commit=False this is a pure peek — cursor, deficits and the
        grant flag are simulated on copies, so it returns exactly what
        the next committed pop will."""
        if self._len == 0:
            return None
        cursor, fresh = self._cursor, self._fresh
        deficit = self._deficit if commit else dict(self._deficit)
        n_t = len(self._order)
        # enough arrivals for the largest queued head to accumulate its
        # cost at the smallest weight, plus slack for empty visits
        biggest = max(q[0].n for q in self._subq.values() if q)
        min_w = min((self._weights[t] for t in self._order
                     if self._subq[t]), default=1.0)
        wraps = 2 + int(biggest / max(self._quantum * min_w, 1e-9))
        for _ in range(wraps * n_t):
            tenant = self._order[cursor % n_t]
            q = self._subq[tenant]
            if not q:
                # an empty queue forfeits its deficit (classic DRR: idle
                # tenants bank no credit)
                deficit[tenant] = 0.0
                cursor += 1
                fresh = True
                continue
            if fresh:
                deficit[tenant] += self._quantum * self._weights[tenant]
                fresh = False
            head = q[0]
            if head.n <= deficit[tenant]:
                if commit:
                    deficit[tenant] -= head.n
                    q.popleft()
                    self._len -= 1
                    if not q or q[0].n > deficit[tenant]:
                        # quantum spent: the next pop starts at the next
                        # tenant with a fresh grant
                        cursor += 1
                        fresh = True
                    self._cursor = cursor % n_t
                    self._fresh = fresh
                return head
            cursor += 1
            fresh = True
        return None  # unreachable: wraps covers the biggest head

    def queued_by_tenant(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._subq.items() if q}
