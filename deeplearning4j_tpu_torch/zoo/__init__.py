"""Model zoo of the port."""
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    LeNet,
    ResNet50,
    TextGenerationLSTM,
    TransformerLM,
    ZooModel,
)
