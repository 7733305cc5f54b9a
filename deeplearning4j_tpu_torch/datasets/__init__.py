"""Datasets and iterators of the port (counterpart of
deeplearning4j_tpu/datasets/, the part the training and checkpoint slices
use)."""
from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    AsyncShieldDataSetIterator,
    AsyncShieldMultiDataSetIterator,
    BenchmarkDataSetIterator,
    DataSetIterator,
    EarlyTerminationDataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: F401
    ImagePreProcessingScaler,
    Normalizer,
    NormalizerMinMaxScaler,
    NormalizerStandardize,
)
