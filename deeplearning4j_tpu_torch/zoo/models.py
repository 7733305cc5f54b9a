"""Model zoo: ZooModel and its fourteen architectures, LeNet, SimpleCNN,
AlexNet, VGG16, VGG19, ResNet50, Darknet19, TextGenerationLSTM,
TransformerLM, VisionTransformer, TinyYOLO, GoogLeNet, InceptionResNetV1
and FaceNetNN4Small2 (counterpart of deeplearning4j_tpu/zoo/models.py;
each `conf()` gives the JAX package's config JSON. The checksummed
pretrained-weight cache is not ported: it downloads).

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
from deeplearning4j_tpu_torch.nn.graph_vertices import (
    ElementWiseVertex,
    L2NormalizeVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LRN,
    Activation,
    BatchNorm,
    CenterLossOutput,
    Conv2D,
    Dense,
    DropoutLayer,
    EmbeddingSequence,
    GlobalPooling,
    GravesLSTM,
    Output,
    PositionEmbedding,
    RnnOutput,
    Subsampling2D,
    TransformerBlock,
    Yolo2Output,
)
from deeplearning4j_tpu_torch.nn.preprocessors import CnnToTokens


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


def _conv_bn_leaky(n_out, k):
    """Darknet's unit: a biasless 'same' conv and a leaky-ReLU BatchNorm."""
    return [Conv2D(kernel_size=(k, k), n_out=n_out, convolution_mode="same",
                   has_bias=False, activation="identity"),
            BatchNorm(activation="leakyrelu")]


@dataclass
class Darknet19(ZooModel):
    """Darknet-19 (zoo/model/Darknet19.java:220), the JAX package's zoo
    Darknet19: 18 conv + leaky BatchNorm units in six stages, a 1x1 conv
    to the classes, global average pooling and a softmax output."""

    def conf(self):
        h, w, c = self.input_shape
        u = _conv_bn_leaky

        def pool():
            return [Subsampling2D(kernel_size=(2, 2), stride=(2, 2))]

        layers = u(32, 3) + pool() + u(64, 3) + pool()
        layers += u(128, 3) + u(64, 1) + u(128, 3) + pool()
        layers += u(256, 3) + u(128, 1) + u(256, 3) + pool()
        layers += (u(512, 3) + u(256, 1) + u(512, 3) + u(256, 1)
                   + u(512, 3) + pool())
        layers += (u(1024, 3) + u(512, 1) + u(1024, 3) + u(512, 1)
                   + u(1024, 3))
        layers += [Conv2D(kernel_size=(1, 1), n_out=self.num_classes,
                          convolution_mode="same", activation="identity"),
                   GlobalPooling(pooling_type="avg"),
                   Output(n_out=self.num_classes, loss="mcxent",
                          activation="softmax", has_bias=True,
                          n_in=self.num_classes)]
        return NeuralNetConfiguration(
            seed=self.seed,
            updater=updaters.Nesterovs(learning_rate=1e-3, momentum=0.9),
            l2=5e-4,
        ).list(layers).set_input_type(it.convolutional(h, w, c))


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


@dataclass
class VisionTransformer(ZooModel):
    """ViT-style image classifier, the JAX package's zoo VisionTransformer:
    a stride-`patch_size` conv as the patch embedding, the spatial
    positions as tokens (CnnToTokens), learned positions, non-causal
    TransformerBlocks and a mean-pooled softmax head."""

    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (32, 32, 3)
    patch_size: int = 4
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4

    def conf(self):
        h, w, c = self.input_shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch {p}")
        conf = NeuralNetConfiguration(
            seed=self.seed, updater=updaters.Adam(learning_rate=3e-4),
            weight_init="xavier",
        ).list([
            Conv2D(kernel_size=(p, p), stride=(p, p), n_out=self.d_model,
                   convolution_mode="truncate", activation="identity"),
            PositionEmbedding(max_len=(h // p) * (w // p)),
            *[TransformerBlock(n_heads=self.n_heads, causal=False)
              for _ in range(self.n_layers)],
            GlobalPooling(pooling_type="avg"),
            Output(n_out=self.num_classes, loss="mcxent"),
        ])
        conf.input_preprocessor(1, CnnToTokens())
        return conf.set_input_type(it.convolutional(h, w, c))


TINY_YOLO_ANCHORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38],
                     [9.42, 5.11], [16.62, 10.52]]


@dataclass
class TinyYOLO(ZooModel):
    """TinyYOLO (zoo/model/TinyYOLO.java:254), the JAX package's zoo
    TinyYOLO: six conv + leaky BatchNorm units with 2x2 pools (the last
    one stride 1, 'same'), a 1024 unit, a 1x1 conv to 5 anchors x (5 +
    classes) and Yolo2Output; a 13x13 grid at 416x416."""

    num_classes: int = 20
    input_shape: Tuple[int, int, int] = (416, 416, 3)

    def conf(self):
        h, w, c = self.input_shape
        layers = []
        for ch in (16, 32, 64, 128, 256):
            layers += _conv_bn_leaky(ch, 3)
            layers.append(Subsampling2D(kernel_size=(2, 2), stride=(2, 2)))
        layers += _conv_bn_leaky(512, 3)
        layers.append(Subsampling2D(kernel_size=(2, 2), stride=(1, 1),
                                    convolution_mode="same"))
        layers += _conv_bn_leaky(1024, 3)
        layers.append(Conv2D(kernel_size=(1, 1),
                             n_out=5 * (5 + self.num_classes),
                             convolution_mode="same", activation="identity"))
        layers.append(Yolo2Output(boxes=[list(b) for b in TINY_YOLO_ANCHORS],
                                  num_classes=self.num_classes))
        return NeuralNetConfiguration(
            seed=self.seed, updater=updaters.Adam(learning_rate=1e-3),
            l2=1e-4,
        ).list(layers).set_input_type(it.convolutional(h, w, c))


def _inception_module(g, name, inp, c1, c3r, c3, c5r, c5, pp):
    """GoogLeNet's inception block (zoo/model/GoogLeNet.java helper): 1x1,
    1x1 -> 3x3, 1x1 -> 5x5 and 3x3 max pool -> 1x1 branches, merged on
    channels. Returns the merge vertex's name."""

    def conv(suffix, k, n, src):
        g.add_layer(f"{name}_{suffix}",
                    Conv2D(kernel_size=(k, k), n_out=n,
                           convolution_mode="same", activation="relu"), src)

    conv("1x1", 1, c1, inp)
    conv("3x3r", 1, c3r, inp)
    conv("3x3", 3, c3, f"{name}_3x3r")
    conv("5x5r", 1, c5r, inp)
    conv("5x5", 5, c5, f"{name}_5x5r")
    g.add_layer(f"{name}_pool",
                Subsampling2D(kernel_size=(3, 3), stride=(1, 1),
                              convolution_mode="same", pooling_type="max"),
                inp)
    conv("poolproj", 1, pp, f"{name}_pool")
    g.add_vertex(f"{name}_out", MergeVertex(), f"{name}_1x1", f"{name}_3x3",
                 f"{name}_5x5", f"{name}_poolproj")
    return f"{name}_out"


def _pool3(g, name, inp):
    g.add_layer(name, Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), inp)
    return name


def _inception_stem(g, c1, c2):
    """GoogLeNet's and FaceNet's stem: 7x7/2 conv, pool, LRN, 1x1 and 3x3
    convs, LRN, pool. Returns the last vertex's name."""
    g.add_layer("stem1", Conv2D(kernel_size=(7, 7), stride=(2, 2), n_out=64,
                                convolution_mode="same", activation="relu"),
                "in")
    _pool3(g, "pool1", "stem1")
    g.add_layer("lrn1", LRN(), "pool1")
    g.add_layer(c1, Conv2D(kernel_size=(1, 1), n_out=64,
                           convolution_mode="same", activation="relu"),
                "lrn1")
    g.add_layer(c2, Conv2D(kernel_size=(3, 3), n_out=192,
                           convolution_mode="same", activation="relu"), c1)
    g.add_layer("lrn2", LRN(), c2)
    return _pool3(g, "pool2", "lrn2")


@dataclass
class GoogLeNet(ZooModel):
    """GoogLeNet / Inception-v1 (zoo/model/GoogLeNet.java:197), the JAX
    package's zoo GoogLeNet: the stem with two LRNs, nine inception
    modules, global average pooling, dropout 0.4 and a softmax output."""

    def conf(self):
        h, w, c = self.input_shape
        g = NeuralNetConfiguration(
            seed=self.seed,
            updater=updaters.Nesterovs(learning_rate=1e-2, momentum=0.9),
            l2=2e-4,
        ).graph().add_inputs("in")
        x = _inception_stem(g, "stem2", "stem3")
        x = _inception_module(g, "i3a", x, 64, 96, 128, 16, 32, 32)
        x = _inception_module(g, "i3b", x, 128, 128, 192, 32, 96, 64)
        x = _pool3(g, "pool3", x)
        for name, widths in (("i4a", (192, 96, 208, 16, 48, 64)),
                             ("i4b", (160, 112, 224, 24, 64, 64)),
                             ("i4c", (128, 128, 256, 24, 64, 64)),
                             ("i4d", (112, 144, 288, 32, 64, 64)),
                             ("i4e", (256, 160, 320, 32, 128, 128))):
            x = _inception_module(g, name, x, *widths)
        x = _pool3(g, "pool4", x)
        x = _inception_module(g, "i5a", x, 256, 160, 320, 32, 128, 128)
        x = _inception_module(g, "i5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("avgpool", GlobalPooling(pooling_type="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("out", Output(n_out=self.num_classes, loss="mcxent"),
                    "dropout")
        g.set_outputs("out")
        g.set_input_types(it.convolutional(h, w, c))
        return g


@dataclass
class InceptionResNetV1(ZooModel):
    """Inception-ResNet v1 (zoo/model/InceptionResNetV1.java:324), the JAX
    package's compact rendition: a stem and five inception-resnet-A blocks
    with residual adds, global average pooling, a bottleneck Dense, an
    L2-normalized embedding and a softmax output."""

    num_classes: int = 128  # embedding net by default (facenet use)

    def conf(self):
        h, w, c = self.input_shape
        g = NeuralNetConfiguration(
            seed=self.seed, updater=updaters.RmsProp(learning_rate=1e-1),
        ).graph().add_inputs("in")

        def conv(name, inp, k, n, stride=(1, 1)):
            g.add_layer(name, Conv2D(kernel_size=k, stride=stride, n_out=n,
                                     convolution_mode="same",
                                     activation="relu"), inp)
            return name

        x = conv("stem1", "in", (3, 3), 32, (2, 2))
        x = conv("stem2", x, (3, 3), 32)
        x = conv("stem3", x, (3, 3), 64)
        _pool3(g, "stem_pool", x)
        x = conv("stem4", "stem_pool", (1, 1), 80)
        x = conv("stem5", x, (3, 3), 192)
        x = conv("stem6", x, (3, 3), 256, (2, 2))
        for i in range(5):
            inp = x
            b0 = conv(f"ira{i}_b0", inp, (1, 1), 32)
            b1 = conv(f"ira{i}_b1a", inp, (1, 1), 32)
            b1 = conv(f"ira{i}_b1b", b1, (3, 3), 32)
            b2 = conv(f"ira{i}_b2a", inp, (1, 1), 32)
            b2 = conv(f"ira{i}_b2b", b2, (3, 3), 32)
            b2 = conv(f"ira{i}_b2c", b2, (3, 3), 32)
            g.add_vertex(f"ira{i}_cat", MergeVertex(), b0, b1, b2)
            g.add_layer(f"ira{i}_up",
                        Conv2D(kernel_size=(1, 1), n_out=256,
                               convolution_mode="same",
                               activation="identity"), f"ira{i}_cat")
            g.add_vertex(f"ira{i}_add", ElementWiseVertex(op="add"),
                         inp, f"ira{i}_up")
            g.add_layer(f"ira{i}_act", Activation(activation="relu"),
                        f"ira{i}_add")
            x = f"ira{i}_act"
        g.add_layer("avgpool", GlobalPooling(pooling_type="avg"), x)
        g.add_layer("bottleneck", Dense(n_out=self.num_classes,
                                        activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", Output(n_out=self.num_classes, loss="mcxent"),
                    "embeddings")
        g.set_outputs("out")
        g.set_input_types(it.convolutional(h, w, c))
        return g


@dataclass
class FaceNetNN4Small2(ZooModel):
    """NN4.small2 face embedding net (zoo/model/FaceNetNN4Small2.java:362),
    the JAX package's zoo FaceNetNN4Small2: GoogLeNet's stem, four
    inception modules, global average pooling, a bottleneck Dense to an
    L2-normalized embedding and a CenterLossOutput."""

    num_classes: int = 1000
    embedding_size: int = 128
    input_shape: Tuple[int, int, int] = (96, 96, 3)

    def conf(self):
        h, w, c = self.input_shape
        g = NeuralNetConfiguration(
            seed=self.seed, updater=updaters.Adam(learning_rate=1e-3),
        ).graph().add_inputs("in")
        x = _inception_stem(g, "i2", "i3")
        x = _inception_module(g, "f3a", x, 64, 96, 128, 16, 32, 32)
        x = _inception_module(g, "f3b", x, 64, 96, 128, 32, 64, 64)
        x = _pool3(g, "pool3", x)
        x = _inception_module(g, "f4a", x, 256, 96, 192, 32, 64, 128)
        x = _inception_module(g, "f5a", x, 256, 96, 384, 16, 64, 96)
        g.add_layer("avgpool", GlobalPooling(pooling_type="avg"), x)
        g.add_layer("bottleneck", Dense(n_out=self.embedding_size,
                                        activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", CenterLossOutput(n_out=self.num_classes,
                                            loss="mcxent", alpha=0.9,
                                            lambda_=2e-4), "embeddings")
        g.set_outputs("out")
        g.set_input_types(it.convolutional(h, w, c))
        return g
