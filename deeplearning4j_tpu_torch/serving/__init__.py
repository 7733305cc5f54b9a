"""serving/ — continuous-batching inference with overload protection.

`InferenceServer` (serving/runtime.py) coalesces requests into bucketed
padded batches (serving/buckets.py) with admission control, per-request
deadlines, load shedding, circuit breaking (serving/breaker.py) and drain on
shutdown; every refusal is a typed ServingError (serving/errors.py).
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
)
from deeplearning4j_tpu_torch.serving.runtime import InferenceServer  # noqa: F401
