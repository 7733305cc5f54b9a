"""The training dashboard and telemetry endpoints (counterpart of
deeplearning4j_tpu/ui/: the same exports)."""
from deeplearning4j_tpu_torch.ui.stats import StatsListener  # noqa: F401
from deeplearning4j_tpu_torch.ui.storage import (  # noqa: F401
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    StatsStorage,
    StatsStorageRouter,
)
from deeplearning4j_tpu_torch.ui.server import UIServer  # noqa: F401
