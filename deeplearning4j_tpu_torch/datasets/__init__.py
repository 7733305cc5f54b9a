"""Datasets, iterators and record readers of the port (counterpart of
deeplearning4j_tpu/datasets)."""
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
    BucketSequenceIterator,
    DataSetIterator,
    EarlyTerminationDataSetIterator,
    ExistingDataSetIterator,
    JointParallelDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
    prefetch_to_device,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    CifarDataSetIterator,
    EmnistDataSetIterator,
    IrisDataSetIterator,
    LfwDataSetIterator,
    MnistDataSetIterator,
    SvhnDataSetIterator,
    TinyImageNetDataSetIterator,
    UciSequenceDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: F401
    ImagePreProcessingScaler,
    Normalizer,
    NormalizerMinMaxScaler,
    NormalizerStandardize,
)
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    CollectionRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    RecordReader,
    RecordReaderDataSetIterator,
    SequenceRecordReader,
    SequenceRecordReaderDataSetIterator,
)
