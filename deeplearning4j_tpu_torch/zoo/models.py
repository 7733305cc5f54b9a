"""Model zoo, the part ported so far: ZooModel and ResNet50 (counterpart of
deeplearning4j_tpu/zoo/models.py; the other eleven architectures and the
checksummed pretrained cache come with later slices).

Each ZooModel builds a fresh config via `conf()` and an initialized network
via `init(device=...)`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.layers import (
    Activation,
    BatchNorm,
    Conv2D,
    GlobalPooling,
    Output,
    Subsampling2D,
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
        """The initialized network on `device` (default: the CUDA card)."""
        return ComputationGraph(self.conf()).init(device)


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
