"""Layer library of the port — importing this module populates the layer
registry with every layer ported so far."""
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    LayerNorm,
    MultiHeadAttention,
    PositionEmbedding,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.layers.autoencoder import (  # noqa: F401
    RBM,
    AutoEncoder,
    VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.convolution import (  # noqa: F401
    Conv1D,
    Conv2D,
    Deconv2D,
    SeparableConv2D,
    Subsampling1D,
    Subsampling2D,
    Upsampling1D,
    Upsampling2D,
    ZeroPadding1D,
    ZeroPadding2D,
)
from deeplearning4j_tpu_torch.nn.layers.dense import (  # noqa: F401
    Activation,
    Dense,
    DropoutLayer,
    ElementWiseMultiplication,
    Embedding,
    EmbeddingSequence,
)
from deeplearning4j_tpu_torch.nn.layers.misc import Frozen  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.normalization import BatchNorm, LRN  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.objdetect import Yolo2Output  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.output import (  # noqa: F401
    BaseOutputLayer,
    CenterLossOutput,
    LossLayer,
    Output,
    RnnOutput,
)
from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPooling  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    LSTM,
    BaseRecurrent,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LastTimeStep,
    SimpleRnn,
)
