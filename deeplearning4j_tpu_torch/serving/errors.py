"""Typed serving errors — the overload-protection contract in exceptions
(the port's own copy of deeplearning4j_tpu/serving/errors.py).

Every way the serving runtime can refuse or fail a request has its own
exception type, because callers (and load balancers in front of them)
react differently to each:

    ShedError              the queue refused admission (or dropped a
                           queued request to make room). Transient by
                           construction — `retry_after_s` hints when
                           capacity is expected back. Retry elsewhere or
                           later.
    DeadlineExceededError  the request's deadline expired — at admission
                           (it could not possibly dispatch in time), in
                           the queue, or mid-flight. Retrying with the
                           same deadline under the same load will fail
                           the same way; shed load or raise the budget.
    CircuitOpenError       the circuit breaker is open after consecutive
                           dispatch failures or non-finite outputs; the
                           model/device path is presumed broken.
                           `retry_after_s` is the time to the next
                           half-open probe window.
    NonFiniteOutputError   the dispatch produced NaN/Inf outputs (the
                           DivergenceSentry's non-finite check applied to
                           inference); the result was discarded rather
                           than served.
    DispatchFailedError    the batch dispatch itself raised; `cause`
                           carries the original exception. Affects only
                           the requests coalesced into that batch.
    ShutdownError          the runtime is shutting down (or already shut
                           down): queued requests are resolved with this
                           instead of blocking forever, and new submits
                           are refused with it.
    DispatcherCrashedError the dispatcher thread died on an unexpected
                           error; queued and future requests surface the
                           crash instead of queueing into a void.
    TenantQuotaError       the *tenant's* token bucket (serving/
                           tenancy.py) refused admission — the fleet has
                           capacity, this caller exhausted its share.
                           A ShedError subclass, so `submit_with_retry`
                           backs off on `retry_after_s` (the bucket's
                           refill horizon) exactly like a queue shed;
                           `tenant` names the offender so a gateway can
                           throttle per caller instead of per fleet.

All subclass ServingError, so `except ServingError` is the one catch
callers need for "request not served, runtime still up". Pure stdlib.
"""
from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """Base class: the request was not served."""


class ShedError(ServingError):
    """Load shed at (or after) admission; retry after `retry_after_s`."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class TenantQuotaError(ShedError):
    """The tenant's own admission quota refused the request; the shared
    queue never saw it. `retry_after_s` is the token-bucket refill time
    for the request's cost."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None,
                 tenant: Optional[str] = None):
        super().__init__(message, retry_after_s=retry_after_s)
        self.tenant = tenant


class DeadlineExceededError(ServingError, TimeoutError):
    """The request's deadline expired before a result could be served."""


class CircuitOpenError(ServingError):
    """Circuit breaker open — dispatch path presumed broken."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class NonFiniteOutputError(ServingError, FloatingPointError):
    """Dispatch produced NaN/Inf outputs; the result was discarded."""


class DispatchFailedError(ServingError):
    """The coalesced batch's dispatch raised; `cause` is the original."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


class ShutdownError(ServingError):
    """Runtime shutting down — request resolved/refused, never parked."""


class DispatcherCrashedError(ServingError):
    """The dispatcher thread died; `cause` is the crash."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause
