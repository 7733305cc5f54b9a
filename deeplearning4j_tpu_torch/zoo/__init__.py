"""Model zoo of the port."""
from deeplearning4j_tpu_torch.zoo.models import ResNet50, ZooModel  # noqa: F401
