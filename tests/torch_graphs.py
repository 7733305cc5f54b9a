"""A small ResNet-shaped ComputationGraph config, shared by the CPU tests
against the JAX package (test_torch_graph_training.py) and the card tests
(test_torch_cuda.py, which import no JAX): a stem conv_bn + max pool, one
projected and one identity bottleneck, global average pooling and a
softmax Output, built with the port's API (its JSON reads the same in the
JAX package)."""
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


def small_resnet_json(**output_extra) -> str:
    """The graph's JSON: zoo ResNet50's defaults (Nesterovs(0.1, 0.9), l2
    1e-4, relu init), 16x16x3 input, 5 classes, widths 8 (stem) and 4/16
    (bottlenecks); `output_extra` goes to the Output layer."""
    g = NeuralNetConfiguration(
        seed=11, updater=updaters.Nesterovs(learning_rate=0.1, momentum=0.9),
        weight_init="relu", l2=1e-4, activation="identity",
    ).graph().add_inputs("in")

    def conv_bn(name, inp, kernel, n_out, stride=(1, 1), act="relu"):
        g.add_layer(f"{name}_conv",
                    Conv2D(kernel_size=kernel, stride=stride, n_out=n_out,
                           convolution_mode="same", has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNorm(activation=act), f"{name}_conv")
        return f"{name}_bn"

    def bottleneck(name, inp, f, stride, project):
        x = conv_bn(f"{name}_a", inp, (1, 1), f[0], stride)
        x = conv_bn(f"{name}_b", x, (3, 3), f[1])
        x = conv_bn(f"{name}_c", x, (1, 1), f[2], act="identity")
        sc = (conv_bn(f"{name}_sc", inp, (1, 1), f[2], stride,
                      act="identity") if project else inp)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        g.add_layer(f"{name}_relu", Activation(activation="relu"),
                    f"{name}_add")
        return f"{name}_relu"

    x = conv_bn("stem", "in", (7, 7), 8, (2, 2))
    g.add_layer("stem_pool", Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                                           convolution_mode="same",
                                           pooling_type="max"), x)
    x = bottleneck("b0", "stem_pool", (4, 4, 16), (2, 2), project=True)
    x = bottleneck("b1", x, (4, 4, 16), (1, 1), project=False)
    g.add_layer("avgpool", GlobalPooling(pooling_type="avg"), x)
    g.add_layer("out", Output(n_out=5, loss="mcxent", **output_extra),
                "avgpool")
    g.set_outputs("out")
    g.set_input_types(it.convolutional(16, 16, 3))
    return g.to_json()
