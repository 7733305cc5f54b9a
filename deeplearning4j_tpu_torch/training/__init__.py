"""The fit loop shared by the port's training entry points (counterpart of
deeplearning4j_tpu/training): step windows, device prefetch and the fit
lifecycle."""
from deeplearning4j_tpu_torch.training.engine import (  # noqa: F401
    TrainingRun,
    WindowedFitLoop,
    device_prefetch_place,
    place_batch,
    window_size,
)
