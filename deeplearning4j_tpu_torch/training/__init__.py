"""The fit lifecycle shared by the port's training entry points
(counterpart of deeplearning4j_tpu/training)."""
from deeplearning4j_tpu_torch.training.engine import (  # noqa: F401
    TrainingRun,
    window_size,
)
