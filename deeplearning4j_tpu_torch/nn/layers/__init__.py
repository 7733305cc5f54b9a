"""Layer library of the port — importing this module populates the layer
registry with every layer ported so far."""
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.convolution import Conv2D, Subsampling2D  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.dense import Activation, Dense  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.normalization import BatchNorm  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.output import Output  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPooling  # noqa: F401
