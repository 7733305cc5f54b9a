"""Model zoo, the part ported so far: ZooModel, LeNet, SimpleCNN, AlexNet,
VGG16, VGG19, ResNet50, TextGenerationLSTM and TransformerLM (counterpart of
deeplearning4j_tpu/zoo/models.py; the other architectures and the
checksummed pretrained cache come with later slices).

Each ZooModel builds a fresh config via `conf()` and an initialized network
via `init(device=...)`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.layers import (
    LRN,
    Activation,
    BatchNorm,
    Conv2D,
    Dense,
    EmbeddingSequence,
    GlobalPooling,
    GravesLSTM,
    Output,
    PositionEmbedding,
    RnnOutput,
    Subsampling2D,
    TransformerBlock,
)


@dataclass
class ZooModel:
    """Base: numClasses/seed/inputShape + init()."""

    num_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (224, 224, 3)  # H, W, C

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """The initialized network on `device` (default: the CUDA card): a
        ComputationGraph for a graph config, else a MultiLayerNetwork."""
        c = self.conf()
        if isinstance(c, ComputationGraphConfiguration):
            return ComputationGraph(c).init(device)
        return MultiLayerNetwork(c).init(device)


@dataclass
class LeNet(ZooModel):
    """LeNet-5 on MNIST-sized input (zoo/model/LeNet.java:129), the JAX
    package's zoo LeNet: the same layers and config JSON. Dense flattens
    its convolutional input itself, so the config has no preprocessors."""

    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (28, 28, 1)

    def conf(self):
        h, w, c = self.input_shape
        return NeuralNetConfiguration(
            seed=self.seed, updater=updaters.Adam(learning_rate=1e-3),
            weight_init="xavier", activation="identity",
        ).list([
            Conv2D(kernel_size=(5, 5), stride=(1, 1), n_out=20,
                   activation="identity", convolution_mode="same"),
            Subsampling2D(kernel_size=(2, 2), stride=(2, 2),
                          pooling_type="max"),
            Conv2D(kernel_size=(5, 5), stride=(1, 1), n_out=50,
                   activation="identity", convolution_mode="same"),
            Subsampling2D(kernel_size=(2, 2), stride=(2, 2),
                          pooling_type="max"),
            Dense(n_out=500, activation="relu"),
            Output(n_out=self.num_classes, loss="mcxent",
                   activation="softmax"),
        ]).set_input_type(it.convolutional(h, w, c))


@dataclass
class SimpleCNN(ZooModel):
    """Compact CNN (zoo/model/SimpleCNN.java:152), the JAX package's zoo
    SimpleCNN: three conv + BatchNorm + max-pool stages, a Dense of 256
    with dropout 0.5 and a softmax output."""

    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (48, 48, 3)

    def conf(self):
        h, w, c = self.input_shape
        return NeuralNetConfiguration(
            seed=self.seed, updater=updaters.AdaDelta(),
            activation="relu", weight_init="relu",
        ).list([
            Conv2D(kernel_size=(7, 7), n_out=16, convolution_mode="same",
                   activation="relu"),
            BatchNorm(),
            Subsampling2D(kernel_size=(2, 2), pooling_type="max"),
            Conv2D(kernel_size=(5, 5), n_out=32, convolution_mode="same",
                   activation="relu"),
            BatchNorm(),
            Subsampling2D(kernel_size=(2, 2), pooling_type="max"),
            Conv2D(kernel_size=(3, 3), n_out=64, convolution_mode="same",
                   activation="relu"),
            BatchNorm(),
            Subsampling2D(kernel_size=(2, 2), pooling_type="max"),
            Dense(n_out=256, activation="relu", dropout=0.5),
            Output(n_out=self.num_classes, loss="mcxent"),
        ]).set_input_type(it.convolutional(h, w, c))


@dataclass
class AlexNet(ZooModel):
    """AlexNet (zoo/model/AlexNet.java:157), the JAX package's zoo AlexNet:
    five convs with LRN and max pools, two Dense of 4096 with dropout 0.5,
    Nesterovs with l2."""

    def conf(self):
        h, w, c = self.input_shape
        return NeuralNetConfiguration(
            seed=self.seed,
            updater=updaters.Nesterovs(learning_rate=1e-2, momentum=0.9),
            weight_init="normal", l2=5e-4,
        ).list([
            Conv2D(kernel_size=(11, 11), stride=(4, 4), n_out=96,
                   activation="relu"),
            LRN(),
            Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                          pooling_type="max"),
            Conv2D(kernel_size=(5, 5), n_out=256, convolution_mode="same",
                   activation="relu", bias_init=1.0),
            LRN(),
            Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                          pooling_type="max"),
            Conv2D(kernel_size=(3, 3), n_out=384, convolution_mode="same",
                   activation="relu"),
            Conv2D(kernel_size=(3, 3), n_out=384, convolution_mode="same",
                   activation="relu", bias_init=1.0),
            Conv2D(kernel_size=(3, 3), n_out=256, convolution_mode="same",
                   activation="relu", bias_init=1.0),
            Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                          pooling_type="max"),
            Dense(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0),
            Dense(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0),
            Output(n_out=self.num_classes, loss="mcxent"),
        ]).set_input_type(it.convolutional(h, w, c))


def _vgg_blocks(spec):
    """(convs, channels) per block -> 3x3 'same' relu convs, each block
    closed by a 2x2 max pool."""
    layers = []
    for n_convs, channels in spec:
        for _ in range(n_convs):
            layers.append(Conv2D(kernel_size=(3, 3), n_out=channels,
                                 convolution_mode="same", activation="relu"))
        layers.append(Subsampling2D(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type="max"))
    return layers


def _vgg_conf(zoo, spec):
    h, w, c = zoo.input_shape
    layers = _vgg_blocks(spec) + [
        Dense(n_out=4096, activation="relu", dropout=0.5),
        Dense(n_out=4096, activation="relu", dropout=0.5),
        Output(n_out=zoo.num_classes, loss="mcxent"),
    ]
    return NeuralNetConfiguration(
        seed=zoo.seed,
        updater=updaters.Nesterovs(learning_rate=1e-2, momentum=0.9),
    ).list(layers).set_input_type(it.convolutional(h, w, c))


@dataclass
class VGG16(ZooModel):
    """VGG-16 (zoo/model/VGG16.java:181), the JAX package's zoo VGG16: 13
    convs in five blocks, two Dense of 4096 with dropout 0.5, Nesterovs;
    138,357,544 params at 224x224x3 and 1000 classes."""

    def conf(self):
        return _vgg_conf(self, [(2, 64), (2, 128), (3, 256), (3, 512),
                                (3, 512)])


@dataclass
class VGG19(ZooModel):
    """VGG-19 (zoo/model/VGG19.java:172), the JAX package's zoo VGG19: as
    VGG16 with 16 convs."""

    def conf(self):
        return _vgg_conf(self, [(2, 64), (2, 128), (4, 256), (4, 512),
                                (4, 512)])


@dataclass
class ResNet50(ZooModel):
    """ResNet-50 (zoo/model/ResNet50.java:239) as a ComputationGraph with
    identity/conv shortcut bottleneck blocks; the same graph, vertex names
    and config as the JAX package's ResNet50."""

    def conf(self):
        h, w, c = self.input_shape
        g = NeuralNetConfiguration(
            seed=self.seed,
            updater=updaters.Nesterovs(learning_rate=1e-1, momentum=0.9),
            weight_init="relu", l2=1e-4, activation="identity",
        ).graph().add_inputs("in")

        def conv_bn(name, inp, kernel, n_out, stride=(1, 1), act="relu",
                    mode="same"):
            g.add_layer(f"{name}_conv",
                        Conv2D(kernel_size=kernel, stride=stride, n_out=n_out,
                               convolution_mode=mode, has_bias=False), inp)
            g.add_layer(f"{name}_bn", BatchNorm(activation=act), f"{name}_conv")
            return f"{name}_bn"

        def bottleneck(name, inp, filters, stride, project):
            f1, f2, f3 = filters
            x = conv_bn(f"{name}_a", inp, (1, 1), f1, stride)
            x = conv_bn(f"{name}_b", x, (3, 3), f2)
            x = conv_bn(f"{name}_c", x, (1, 1), f3, act="identity")
            if project:
                sc = conv_bn(f"{name}_sc", inp, (1, 1), f3, stride,
                             act="identity")
            else:
                sc = inp
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
            g.add_layer(f"{name}_relu", Activation(activation="relu"),
                        f"{name}_add")
            return f"{name}_relu"

        x = conv_bn("stem", "in", (7, 7), 64, (2, 2))
        g.add_layer("stem_pool",
                    Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                                  convolution_mode="same",
                                  pooling_type="max"), x)
        x = "stem_pool"
        stages = [
            ("s2", [64, 64, 256], 3, (1, 1)),
            ("s3", [128, 128, 512], 4, (2, 2)),
            ("s4", [256, 256, 1024], 6, (2, 2)),
            ("s5", [512, 512, 2048], 3, (2, 2)),
        ]
        for sname, filters, blocks, stride in stages:
            x = bottleneck(f"{sname}_0", x, filters, stride, project=True)
            for b in range(1, blocks):
                x = bottleneck(f"{sname}_{b}", x, filters, (1, 1),
                               project=False)
        g.add_layer("avgpool", GlobalPooling(pooling_type="avg"), x)
        g.add_layer("out", Output(n_out=self.num_classes, loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        g.set_input_types(it.convolutional(h, w, c))
        return g


@dataclass
class TextGenerationLSTM(ZooModel):
    """Char-level 2xLSTM generator (zoo/model/TextGenerationLSTM.java:111),
    the JAX package's zoo TextGenerationLSTM: two GravesLSTM(256) layers
    and a per-timestep softmax over the vocabulary. Input: [b, t, vocab]
    one-hot characters. The updater and l2 are carried as config."""

    num_classes: int = 77  # vocab size
    max_length: int = 40

    def conf(self):
        return NeuralNetConfiguration(
            seed=self.seed, updater=updaters.RmsProp(learning_rate=1e-2),
            l2=1e-4,
        ).list([
            GravesLSTM(n_out=256, activation="tanh"),
            GravesLSTM(n_out=256, activation="tanh"),
            RnnOutput(n_out=self.num_classes, loss="mcxent",
                      activation="softmax"),
        ]).set_input_type(it.recurrent(self.num_classes, self.max_length))


@dataclass
class TransformerLM(ZooModel):
    """Decoder-only transformer LM built from the layer library, the JAX
    package's zoo TransformerLM: token embedding, learned positions,
    `n_layers` causal pre-LN TransformerBlocks, a per-timestep softmax over
    the vocabulary. Input: [b, t] token ids."""

    num_classes: int = 1000  # vocab
    max_length: int = 128
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    # per-block activation-checkpoint policy, carried in the config for
    # training ('none' | 'dots_saveable' | 'full' | 'offload')
    remat: Optional[str] = None

    def conf(self):
        blocks = [TransformerBlock(n_heads=self.n_heads, causal=True,
                                   remat=self.remat)
                  for _ in range(self.n_layers)]
        return NeuralNetConfiguration(
            seed=self.seed, updater=updaters.Adam(learning_rate=3e-4),
            weight_init="xavier",
        ).list([
            EmbeddingSequence(n_in=self.num_classes, n_out=self.d_model),
            PositionEmbedding(max_len=self.max_length),
            *blocks,
            RnnOutput(n_out=self.num_classes, loss="mcxent",
                      activation="softmax"),
        ]).set_input_type(it.recurrent(self.num_classes, self.max_length))
