"""Model zoo of the port."""
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    VGG16,
    VGG19,
    AlexNet,
    Darknet19,
    FaceNetNN4Small2,
    GoogLeNet,
    InceptionResNetV1,
    LeNet,
    ResNet50,
    SimpleCNN,
    TextGenerationLSTM,
    TinyYOLO,
    TransformerLM,
    VisionTransformer,
    ZooModel,
)
