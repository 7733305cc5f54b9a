"""Resilience of the port's training (counterpart of
deeplearning4j_tpu/resilience): atomic rotating checkpoints with manifests
(`checkpoint`), their listener, the divergence sentry (`sentry`) and retry
with backoff and deadlines (`retry`). The chaos fault points are not
ported yet (ROADMAP A.11)."""
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
from deeplearning4j_tpu_torch.resilience.sentry import (  # noqa: F401
    DivergenceSentry,
    restore_training_state,
    snapshot_training_state,
    tree_all_finite,
)
