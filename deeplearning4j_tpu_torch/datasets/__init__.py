"""In-memory datasets and iterators of the port (counterpart of
deeplearning4j_tpu/datasets/, the part the training slice uses)."""
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    DataSetIterator,
    ListDataSetIterator,
)
