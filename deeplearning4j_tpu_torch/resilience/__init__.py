"""Resilience of the port's training (counterpart of
deeplearning4j_tpu/resilience): atomic rotating checkpoints with manifests
(`checkpoint`), their listener, the divergence sentry (`sentry`), retry
with backoff and deadlines (`retry`) and deterministic fault injection
(`chaos`: the `DL4J_TPU_CHAOS` fault points and ChaosDataSetIterator)."""
from deeplearning4j_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosDataSetIterator,
    ChaosError,
    fault_point,
    reset_fault_points,
    silent_fault,
)
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
