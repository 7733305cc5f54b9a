"""Client-side retry for shed and broken-circuit requests (counterpart of
deeplearning4j_tpu/serving/client.py).

`ShedError` (TenantQuotaError included) and `CircuitOpenError` carry a
`retry_after_s` hint — the runtime's own estimate of when capacity
returns. `submit_with_retry` is the one loop that honours it: it retries
ONLY those transient refusals, sleeps the LONGER of the hint and a
decorrelated-jitter backoff step (`resilience/retry.py`: a fleet of
callers shed together must not re-stampede together), and bounds the
whole operation with an optional deadline. Non-transient failures
(deadline expiry, dispatch errors, shutdown) propagate at once: retrying
them under the same conditions fails the same way.

Works against anything exposing `output(x, deadline_s=...)` — an
`InferenceServer`, a registry's `ModelVersion.server`, a
`ParallelInference` — or, with `model=`, against a `Router`
(serving/router.py) passed as `server`: each attempt is then
`router.output(model, x, ...)`, routed by model name (canary split,
autoscaled pool). Every retried refusal ticks
`dl4j_tpu_serving_client_retries_total{error}`.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from deeplearning4j_tpu_torch.resilience.retry import (
    Deadline,
    decorrelated_backoff,
)
from deeplearning4j_tpu_torch.serving.errors import CircuitOpenError, ShedError
from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod

_CLIENT_RETRIES = metrics_mod.counter(
    "dl4j_tpu_serving_client_retries_total",
    "submit_with_retry attempts that were shed/rejected and retried, "
    "by error type",
    labelnames=("error",))


def submit_with_retry(server, x, *, model: Optional[str] = None,
                      attempts: int = 5,
                      base_backoff_s: float = 0.05,
                      max_backoff_s: float = 5.0,
                      deadline_s: Optional[float] = None,
                      request_deadline_s: Optional[float] = None,
                      sleep: Callable[[float], None] = time.sleep,
                      rng: Optional[random.Random] = None):
    """Blocking inference that rides out transient refusals.

    Retries `ShedError` / `CircuitOpenError` up to `attempts` times,
    sleeping `max(retry_after_s hint, decorrelated backoff)` between
    tries, where the backoff step is `min(cap, uniform(base,
    3 * previous))`. `deadline_s` bounds the WHOLE operation — once
    spent, the last refusal is re-raised instead of sleeping again;
    `request_deadline_s` is each attempt's serving deadline. With
    `model`, `server` is a Router and the request routes by that name;
    without it `server` is called as an InferenceServer."""
    dl = Deadline(deadline_s) if deadline_s is not None else None
    prev_delay = base_backoff_s
    last: Optional[BaseException] = None
    for i in range(max(1, int(attempts))):
        if dl is not None and dl.expired and last is not None:
            raise last
        try:
            if model is not None:
                return server.output(model, x,
                                     deadline_s=request_deadline_s)
            return server.output(x, deadline_s=request_deadline_s)
        except (ShedError, CircuitOpenError) as e:
            last = e
            _CLIENT_RETRIES.labels(type(e).__name__).inc()
            if i == attempts - 1:
                raise
            delay = decorrelated_backoff(prev_delay, base_backoff_s,
                                         max_backoff_s, rng=rng)
            hint = getattr(e, "retry_after_s", None)
            if hint is not None and hint > 0:
                # the runtime KNOWS when capacity returns (breaker
                # cooldown, queue estimate); sleeping less than the hint
                # just burns an attempt on a guaranteed refusal
                delay = max(delay, min(float(hint), max_backoff_s))
            prev_delay = delay
            if dl is not None:
                if dl.expired:
                    raise
                delay = min(delay, max(0.0, dl.remaining()))
            if delay > 0:
                sleep(delay)
    raise last  # unreachable: the loop either returns or raises
