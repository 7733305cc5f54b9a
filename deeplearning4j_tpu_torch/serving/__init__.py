"""serving/ — continuous-batching inference with overload protection.

`InferenceServer` (serving/runtime.py) coalesces requests into bucketed
padded batches (serving/buckets.py) with admission control, per-request
deadlines, load shedding, tenant quotas and weighted-fair queues
(serving/tenancy.py), circuit breaking (serving/breaker.py) and drain on
shutdown; every refusal is a typed ServingError (serving/errors.py).
`ModelRegistry` (serving/registry.py) hosts many named, versioned models
side by side from zoo names, Keras files, checkpoint zips and checkpoint
directories; `Router` (serving/router.py) dispatches on model name and
runs SLO-gated canary rollouts with auto-rollback; `Autoscaler`
(serving/autoscaler.py) keeps an elastic pool of replica servers of one
version behind the Router; `warmstart` (serving/warmstart.py) records
warm manifests so a restarted replica warms up without an example;
`submit_with_retry` (serving/client.py) is the client loop for shed and
broken-circuit refusals, straight to a server or routed by model name. `parallel.ParallelInference` routes through the runtime when
the `DL4J_TPU_SERVING` gate is on.

The error, bucket and breaker modules are light and imported eagerly; the
runtime and fleet layers resolve on first touch, so that importing the
package — as parallel/inference.py does for its typed drain errors —
keeps the gate-off path free of them.
"""
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker  # noqa: F401
from deeplearning4j_tpu_torch.serving.buckets import BucketSpec  # noqa: F401
from deeplearning4j_tpu_torch.serving.errors import (  # noqa: F401
    CircuitOpenError,
    DeadlineExceededError,
    DispatchFailedError,
    DispatcherCrashedError,
    NonFiniteOutputError,
    ServingError,
    ShedError,
    ShutdownError,
    TenantQuotaError,
)

SERVING_GATE = "DL4J_TPU_SERVING"

# attribute -> submodule; resolved on first touch so the gate-off path
# imports none of them
_LAZY = {
    "InferenceServer": "runtime",
    "healthz_section": "runtime",
    "ModelRegistry": "registry",
    "ModelVersion": "registry",
    "ModelEntry": "registry",
    "live_registries": "registry",
    "resolve_model": "registry",
    "TenancyController": "tenancy",
    "TenantPolicy": "tenancy",
    "TenantQueue": "tenancy",
    "Router": "router",
    "Rollout": "router",
    "models_section": "router",
    "Autoscaler": "autoscaler",
    "ReplicaServer": "autoscaler",
    "fleet_section": "autoscaler",
    "submit_with_retry": "client",
    "warmstart": "warmstart",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        module = importlib.import_module(
            f"deeplearning4j_tpu_torch.serving.{mod}")
        return module if name == mod else getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

