"""Resilience of the port's training (counterpart of
deeplearning4j_tpu/resilience): atomic rotating checkpoints with manifests
(`checkpoint`), their listener, and retry with backoff and deadlines
(`retry`). The divergence sentry (`sentry`) and the chaos fault points are
not ported yet (ROADMAP A.7, A.11)."""
from deeplearning4j_tpu_torch.resilience.checkpoint import (  # noqa: F401
    CheckpointListener,
    CheckpointManager,
    atomic_write_json,
    atomic_write_model,
)
from deeplearning4j_tpu_torch.resilience.retry import (  # noqa: F401
    Deadline,
    decorrelated_backoff,
    retry,
    retry_call,
    seed_jitter,
)
