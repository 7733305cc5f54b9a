"""InferenceServer — overload-hardened continuous-batching serving
(counterpart of deeplearning4j_tpu/serving/runtime.py).

One background dispatcher thread owns the device; callers submit requests
that are coalesced into bucketed padded batches (serving/buckets.py) and
dispatched through the model's forward — and every way that can go wrong
under heavy traffic is a typed, bounded outcome instead of an unbounded
queue or a hung caller:

  admission control   a request whose deadline (resilience/retry.py
                      Deadline) would expire before its bucket could
                      dispatch — estimated from the coalesce window plus
                      an EMA of recent dispatch latency scaled by queue
                      depth — is rejected at submit with
                      DeadlineExceededError rather than queued to die.
  load shedding       the queue is bounded; past `queue_limit` the
                      configured policy sheds: `reject_newest` (refuse
                      the submit with ShedError + retry-after hint) or
                      `drop_oldest` (resolve the oldest queued request
                      with ShedError to admit the newer). The hint is
                      floored by the breaker's cooldown remaining when
                      the circuit is open.
  circuit breaking    consecutive dispatch failures or non-finite
                      outputs (checked on the device with torch.isfinite)
                      open the breaker (serving/breaker.py): requests
                      are rejected FAST with CircuitOpenError while
                      half-open probes test recovery.
  drain on shutdown   shutdown() completes the in-flight batch, resolves
                      every queued request with ShutdownError, and a
                      dispatcher crash resolves queued + future requests
                      with DispatcherCrashedError. No caller ever blocks
                      forever: output() waits in bounded slices, keyed
                      to its deadline.

A model is dispatched on its own device (`align=1`): the padded batch goes
through `model.output`, and the result comes back to the host once per
batch. The JAX package's mesh sharding, telemetry spans and metrics, chaos
fault points, tenant queues, lock-order sentinel and bucket re-cut join
with later slices; the control flow here is theirs without those hooks.

Config gates, read at construction through util/envflags.py (the JAX
package's names): DL4J_TPU_SERVING_SHED (reject_newest | drop_oldest),
DL4J_TPU_SERVING_DEADLINE (default per-request deadline seconds; 0/unset =
none), DL4J_TPU_SERVING_BREAK_AFTER (5), DL4J_TPU_SERVING_COOLDOWN (1.0 s),
DL4J_TPU_SERVING_PROBES (2).
"""
from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.retry import Deadline
from deeplearning4j_tpu_torch.serving import buckets as buckets_mod
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.serving.errors import (
    CircuitOpenError,
    DeadlineExceededError,
    DispatchFailedError,
    DispatcherCrashedError,
    NonFiniteOutputError,
    ServingError,
    ShedError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.util import envflags

logger = logging.getLogger("deeplearning4j_tpu_torch")

SHED_POLICIES = ("reject_newest", "drop_oldest")


class _Pending:
    """One admitted request: resolved exactly once with a result or a
    typed error; `event` is the caller's bounded-wait handle."""

    __slots__ = ("x", "n", "sig", "deadline", "event", "result", "error",
                 "enqueued_perf", "probe")

    def __init__(self, x: np.ndarray, deadline: Deadline):
        self.x = x
        self.n = x.shape[0]
        self.sig = buckets_mod.signature(x)
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.enqueued_perf = time.perf_counter()
        # True while this request HOLDS a half-open probe slot: a
        # dispatch result repays it via record_success/record_failure;
        # any no-dispatch resolution must release_probe() instead
        self.probe = False


def _to_host(out: torch.Tensor) -> np.ndarray:
    """A dispatch result as a host array (bfloat16, which numpy lacks,
    widens to float32)."""
    out = out.detach()
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


class InferenceServer:
    """Continuous-batching inference with overload protection.

    Pass a `model` (anything with ``output(x)`` returning a tensor, such as
    a port ComputationGraph on its device) or a raw ``dispatch(batch) ->
    outputs`` callable (tests, custom stacks). `buckets` defaults to
    power-of-two sizes up to `batch_limit`.
    """

    def __init__(self, model=None, dispatch: Optional[Callable] = None,
                 batch_limit: int = 32, queue_limit: int = 64,
                 wait_ms: float = 2.0,
                 buckets: Optional[buckets_mod.BucketSpec] = None,
                 shed_policy: Optional[str] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 warmup_example=None,
                 name: str = "serving"):
        if model is None and dispatch is None:
            raise ValueError("InferenceServer needs a model or a dispatch "
                             "callable")
        self.name = name
        self.batch_limit = max(1, int(batch_limit))
        self.queue_limit = max(1, int(queue_limit))
        self.wait_ms = max(0.0, float(wait_ms))
        self.model = model
        if dispatch is None:
            dispatch = self._build_model_dispatch(model)
        self._dispatch = dispatch
        self.buckets = buckets or buckets_mod.BucketSpec(self.batch_limit)
        if shed_policy is None:
            shed_policy = envflags.value("DL4J_TPU_SERVING_SHED",
                                         "reject_newest")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy {shed_policy!r} not in "
                             f"{SHED_POLICIES}")
        self.shed_policy = shed_policy
        if default_deadline_s is None:
            default_deadline_s = envflags.float_value(
                "DL4J_TPU_SERVING_DEADLINE", 0.0)
        # 0 / unset = no default deadline (Deadline(None) never expires)
        self._default_deadline_s = (float(default_deadline_s)
                                    if default_deadline_s
                                    and default_deadline_s > 0 else None)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=envflags.int_value(
                "DL4J_TPU_SERVING_BREAK_AFTER", 5),
            cooldown_s=envflags.float_value(
                "DL4J_TPU_SERVING_COOLDOWN", 1.0),
            probe_successes=envflags.int_value(
                "DL4J_TPU_SERVING_PROBES", 2))
        if self.breaker.on_open is None:
            self.breaker.on_open = self._on_breaker_open
        self._cond = threading.Condition(threading.Lock())
        # bounded by queue_limit's shed policy at admission, not by maxlen:
        # a maxlen overflow would silently drop a request whose caller is
        # parked on its event
        self._q: "deque[_Pending]" = deque()  # guarded-by: self._cond
        self._stopping = False  # guarded-by: self._cond
        self._stopped = False
        self._crash: Optional[BaseException] = None  # guarded-by: self._cond
        self._ema_latency_s: Optional[float] = None  # guarded-by: self._cond
        self._lat: "deque[float]" = deque(maxlen=512)  # guarded-by: self._cond
        self._depths: "deque[int]" = deque(maxlen=512)  # guarded-by: self._cond
        self.warmed_rows: set = set()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"InferenceServer-dispatch-{name}")
        self._thread.start()
        if warmup_example is not None:
            self.warmup(warmup_example)

    # ------------------------------------------------------------------
    # dispatch construction / warmup
    # ------------------------------------------------------------------
    @staticmethod
    def _build_model_dispatch(model):
        def dispatch(xp, _model=model):
            return _model.output(xp)

        return dispatch

    def warmup(self, example) -> None:
        """Dispatch one batch per bucket size before traffic arrives, so
        cuDNN's algorithm choice, the kernels' first launches and the
        allocator's blocks for every bucket are paid for up front. The
        batches go through the dispatcher thread, like traffic: PyTorch
        creates its cuDNN and cuBLAS handles per thread, and a warmup on
        the caller's thread would leave them to the first real batch.
        `example` is a real request array (leading batch axis included);
        its first row is the template. Raises the typed error of a batch
        that fails."""
        row = np.asarray(example)[:1]
        sig = buckets_mod.signature(row)
        for b in self.buckets.sizes:
            # not a client request: no deadline
            self.result(self.submit(np.repeat(row, b, axis=0),
                                    deadline_s=math.inf))
            self.warmed_rows.add((sig, b))
        # first-call times are not traffic: admission estimates and latency
        # percentiles start from the first real batch
        with self._cond:
            self._ema_latency_s = None
            self._lat.clear()
            self._depths.clear()

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def output(self, x, deadline_s: Optional[float] = None) -> np.ndarray:
        """Blocking inference; raises a typed ServingError subclass when
        the request is shed, expired, broken-circuit, or the runtime is
        down. Never blocks past the deadline (plus one wait slice)."""
        return self.result(self.submit(x, deadline_s=deadline_s))

    def submit(self, x, deadline_s: Optional[float] = None) -> _Pending:
        """Admission control: refuse (typed) or enqueue. See the module
        docstring for the decision order."""
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("request must have a leading batch axis")
        deadline = Deadline(deadline_s if deadline_s is not None
                            else self._default_deadline_s)
        req = _Pending(x, deadline)
        with self._cond:
            if self._crash is not None:
                raise DispatcherCrashedError(
                    f"serving dispatcher died: {self._crash!r}",
                    cause=self._crash)
            if self._stopping:
                raise ShutdownError("serving runtime is shut down")
            allowed, holds_probe = self.breaker.admit()
            if not allowed:
                raise CircuitOpenError(
                    "circuit breaker open (consecutive dispatch "
                    "failures or non-finite outputs)",
                    retry_after_s=self.breaker.retry_after_s())
            req.probe = holds_probe
            est = self._admission_estimate_locked()
            if deadline.remaining() < est:
                self._release_if_probe(req)
                raise DeadlineExceededError(
                    f"deadline {deadline.seconds:.3g}s cannot be met: "
                    f"estimated time to result {est:.3g}s at queue "
                    f"depth {len(self._q)}")
            if len(self._q) >= self.queue_limit:
                # the retry hint floors the queue estimate with the
                # breaker's cooldown remaining: a shed raced against an
                # opening circuit must not invite a retry that lands inside
                # the open window and burns an attempt
                hint = self._retry_hint_locked(est)
                if self.shed_policy == "drop_oldest":
                    oldest = self._q.popleft()
                    self._release_if_probe(oldest)
                    self._resolve(oldest, error=ShedError(
                        "dropped from a full queue to admit a newer "
                        "request (shed_policy=drop_oldest)",
                        retry_after_s=hint))
                else:
                    self._release_if_probe(req)
                    raise ShedError(
                        f"queue full ({self.queue_limit} requests; "
                        f"shed_policy=reject_newest)",
                        retry_after_s=hint)
            self._q.append(req)
            self._cond.notify()
        return req

    def result(self, req: _Pending) -> np.ndarray:
        """Bounded wait for one submitted request: every wait carries a
        timeout, and liveness is re-checked per slice."""
        while not req.event.wait(min(0.05, max(
                0.001, req.deadline.remaining()
                if req.deadline.seconds is not None else 0.05))):
            if req.deadline.expired:
                self._expire_queued(req)
                if not req.event.is_set():
                    # in flight (or just resolved): the caller's budget
                    # is spent either way
                    raise DeadlineExceededError(
                        f"request missed its {req.deadline.seconds:.3g}s "
                        f"deadline (in flight or queued behind a slow "
                        f"dispatch)")
            with self._cond:
                crash = self._crash
            if crash is not None and not req.event.is_set():
                raise DispatcherCrashedError(
                    f"serving dispatcher died: {crash!r}", cause=crash)
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self, timeout: float = 5.0) -> None:
        """Drain: finish the in-flight batch, resolve every queued
        request with ShutdownError, stop the dispatcher. Idempotent;
        bounded by `timeout`."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        dl = Deadline(timeout)
        while self._thread.is_alive() and not dl.expired:
            self._thread.join(0.05)
        # belt: if the thread was already dead (crash path) anything
        # still queued is resolved here — a shutdown must leave zero
        # parked callers behind
        self._drain(ShutdownError("serving runtime shut down"))
        self._stopped = True

    @property
    def stopped(self) -> bool:
        return self._stopped

    @property
    def crashed(self) -> bool:
        """True once the dispatcher thread has died on an unexpected
        error."""
        with self._cond:
            return self._crash is not None

    def snapshot(self) -> dict:
        """Machine-readable state: queue, latency percentiles, breaker."""
        with self._cond:  # rings are written under this lock too
            depth = len(self._q)
            lat = sorted(self._lat)
            depths = sorted(self._depths)
            stopping = self._stopping
            ema = self._ema_latency_s

        def pct(vals, q):
            if not vals:
                return None
            return vals[min(len(vals) - 1, int(q * (len(vals) - 1)))]

        return {
            "name": self.name,
            "queue_depth": depth,
            "queue_limit": self.queue_limit,
            "queue_depth_p50": pct(depths, 0.5),
            "shed_policy": self.shed_policy,
            "buckets": list(self.buckets.sizes),
            "latency_p50_s": (round(pct(lat, 0.5), 6) if lat else None),
            "latency_p99_s": (round(pct(lat, 0.99), 6) if lat else None),
            "ema_latency_s": (round(ema, 6) if ema is not None else None),
            "breaker": self.breaker.snapshot(),
            "stopping": stopping,
        }

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _release_if_probe(self, req: _Pending) -> None:
        """Repay a half-open probe slot when its request resolves WITHOUT
        a dispatch result (queue expiry, drop_oldest victim, drain,
        crash): an unreturned slot wedges the breaker in HALF_OPEN
        rejecting every future request."""
        if req.probe:
            req.probe = False
            self.breaker.release_probe()

    def _retry_hint_locked(self, est: Optional[float] = None) -> float:
        """Retry-after hint for shed resolutions: the queue-pressure
        estimate, floored by the breaker's cooldown remaining."""
        if est is None:
            est = self._admission_estimate_locked()
        return max(est, self.breaker.retry_after_s())

    def _admission_estimate_locked(self) -> float:
        """Expected submit->result time at the current depth: the
        coalesce window plus the dispatch-latency EMA once per already-
        queued bucketful ahead of this request (cond lock held)."""
        est = self.wait_ms / 1000.0
        if self._ema_latency_s is not None:
            waves = 1 + len(self._q) // self.batch_limit
            est += self._ema_latency_s * waves
        return est

    @staticmethod
    def _resolve(req: _Pending, result=None, error=None) -> None:
        req.result = result
        req.error = error
        req.event.set()

    def _expire_queued(self, req: _Pending) -> None:
        """Caller-side deadline expiry: remove + resolve if still
        queued (under the lock, so the dispatcher can't also take it)."""
        with self._cond:
            try:
                self._q.remove(req)
            except ValueError:
                return  # popped for dispatch (or already resolved)
        self._release_if_probe(req)
        self._resolve(req, error=DeadlineExceededError(
            f"deadline {req.deadline.seconds:.3g}s expired in queue"))

    def _pop_expired_locked(self) -> List[_Pending]:
        out = []
        while self._q and self._q[0].deadline.expired:
            out.append(self._q.popleft())
        return out

    def _fail_expired(self, expired: List[_Pending]) -> None:
        for r in expired:
            self._release_if_probe(r)
            self._resolve(r, error=DeadlineExceededError(
                f"deadline {r.deadline.seconds:.3g}s expired in queue"))

    def _next_batch(self) -> Optional[List[_Pending]]:
        """Pop + coalesce: FIFO head defines the shape signature; only
        matching requests join, never past `batch_limit` rows (an
        oversize single request dispatches alone). Returns None when
        stopping."""
        while True:
            with self._cond:
                expired = self._pop_expired_locked()
                if self._stopping:
                    # drain semantics: the in-flight batch completes,
                    # everything still queued resolves with ShutdownError
                    # (in _loop's drain) — shutdown time is bounded by ONE
                    # dispatch, not the queue depth
                    first = None
                elif self._q:
                    first = self._q.popleft()
                    self._depths.append(len(self._q))
                else:
                    self._cond.wait(0.05)
                    first = False  # retry
            if expired:
                self._fail_expired(expired)
            if first is None:
                return None
            if first is not False:
                break
        batch = [first]
        total = first.n
        end = time.perf_counter() + self.wait_ms / 1000.0
        while total < self.batch_limit:
            with self._cond:
                expired = self._pop_expired_locked()
                nxt = self._q[0] if self._q else None
                take = (nxt is not None and nxt.sig == first.sig
                        and total + nxt.n <= self.batch_limit)
                if take:
                    self._q.popleft()
                stop_now = self._stopping
                if not take and nxt is None and not stop_now:
                    rem = end - time.perf_counter()
                    if rem > 0:
                        self._cond.wait(min(rem, 0.02))
            if expired:
                self._fail_expired(expired)
            if take:
                batch.append(nxt)
                total += nxt.n
                continue
            if nxt is not None or stop_now:
                break  # signature/size boundary, or draining
            if time.perf_counter() >= end:
                break
        return batch

    def _fail_batch(self, batch: List[_Pending], error: ServingError,
                    reason: str) -> None:
        # record_failure repays the batch's probe slot (max_probes=1:
        # at most one per batch); clear the flags so no later path
        # double-releases
        for r in batch:
            r.probe = False
        self.breaker.record_failure(reason)
        for r in batch:
            self._resolve(r, error=error)

    def _dispatch_batch(self, batch: List[_Pending]) -> None:
        total = sum(r.n for r in batch)
        target = self.buckets.padded_size(total)
        t0 = time.perf_counter()
        try:
            x = (np.concatenate([r.x for r in batch], axis=0)
                 if len(batch) > 1 else batch[0].x)
            out = torch.as_tensor(self._dispatch(
                buckets_mod.pad_rows(x, target)))
            # on the output's device: one reduction, one sync
            if not bool(torch.isfinite(out).all()):
                raise NonFiniteOutputError(
                    f"non-finite outputs from bucket {target} "
                    f"(result discarded)")
            out = _to_host(out)
        except NonFiniteOutputError as e:
            self._fail_batch(batch, e, "non-finite output")
        except Exception as e:
            self._fail_batch(
                batch, DispatchFailedError(
                    f"batch dispatch failed: {type(e).__name__}: {e}",
                    cause=e),
                f"{type(e).__name__}: {e}")
        else:
            now = time.perf_counter()
            dt = now - t0
            # the EMA feeds _admission_estimate_locked on admit threads:
            # update it under the same lock those reads hold
            with self._cond:
                self._ema_latency_s = (
                    dt if self._ema_latency_s is None
                    else 0.8 * self._ema_latency_s + 0.2 * dt)
            for r in batch:  # record_success repays the batch's probe
                r.probe = False
            self.breaker.record_success()
            off = 0
            lats = []
            for r in batch:
                r.result = out[off:off + r.n]
                off += r.n
                lats.append(now - r.enqueued_perf)
                r.event.set()
            with self._cond:
                self._lat.extend(lats)

    def _drain(self, error: ServingError) -> None:
        with self._cond:
            pending = list(self._q)
            self._q.clear()
        for r in pending:
            self._release_if_probe(r)
            self._resolve(r, error=error)

    def _on_breaker_open(self, reason: str) -> None:
        logger.warning("serving circuit breaker OPEN (%s); rejecting "
                       "requests for %.3gs", reason,
                       self.breaker.cooldown_s)

    def _loop(self) -> None:
        inflight: List[_Pending] = []
        try:
            while True:
                batch = self._next_batch()
                if batch is None:
                    break
                inflight = batch
                self._dispatch_batch(batch)
                inflight = []
        except BaseException as e:  # a dispatcher bug must not strand callers
            with self._cond:
                self._crash = e
            logger.exception("serving dispatcher crashed")
            err = DispatcherCrashedError(
                f"serving dispatcher died: {e!r}", cause=e)
            # the crashing batch was already popped — the queue drain
            # alone would strand exactly those callers (and their probe
            # slots: the crash skipped record_success/record_failure)
            for r in inflight:
                if not r.event.is_set():
                    self._release_if_probe(r)
                    self._resolve(r, error=err)
            self._drain(err)
        else:
            self._drain(ShutdownError("serving runtime shut down"))
