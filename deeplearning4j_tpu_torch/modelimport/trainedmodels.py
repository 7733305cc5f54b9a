"""Trained-model helpers: the canonical Keras InceptionV3 architecture and
the preprocessing of the pretrained nets (the port's own copy of
deeplearning4j_tpu/modelimport/trainedmodels.py, less its download part).

`inception_v3` returns the Keras 2 functional-model JSON of InceptionV3
(Szegedy et al. 2015, "Rethinking the Inception Architecture", as
keras.applications builds it): stem, mixed0-2 (35x35), mixed3 reduction,
mixed4-7 (17x17 factorized 7x7), mixed8 reduction, mixed9-10 (8x8
expanded), global average pooling and softmax; 299x299x3 input, 94
conv/BN pairs, 23,834,568 parameters at 1000 classes (the moving
statistics aside). For the same arguments it returns the same dict as the
JAX package's function, and `write_inception_v3_h5` writes the same
datasets, bit for bit, with the port's HDF5 writer (modelimport/hdf5.py).
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.modelimport import hdf5


# ---------------------------------------------------------------------------
# preprocessing (TrainedModels.VGG16.getPreProcessor / imagenet utils)
# ---------------------------------------------------------------------------

VGG_MEAN_BGR = (103.939, 116.779, 123.68)


def vgg16_preprocess(x: np.ndarray) -> np.ndarray:
    """RGB [0,255] NHWC -> BGR mean-subtracted (caffe-style, what VGG16
    weights expect; TrainedModels.VGG16 preprocessing)."""
    x = np.asarray(x, np.float32)[..., ::-1].copy()
    for c, m in enumerate(VGG_MEAN_BGR):
        x[..., c] -= m
    return x


def inception_preprocess(x: np.ndarray) -> np.ndarray:
    """RGB [0,255] -> [-1, 1] (tf-style, InceptionV3/ResNetV2 family)."""
    return np.asarray(x, np.float32) / 127.5 - 1.0


# ---------------------------------------------------------------------------
# InceptionV3 architecture generator (Keras 2 functional-model JSON)
# ---------------------------------------------------------------------------


class _InceptionBuilder:
    def __init__(self):
        self.layers: List[dict] = []
        self.weights: List[Tuple[str, List[Tuple[str, tuple]]]] = []
        self._n = 0

    def _name(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}_{self._n}"

    def _add(self, class_name: str, cfg: dict, inbound: List[str],
             weights: Optional[List[Tuple[str, tuple]]] = None) -> str:
        name = cfg["name"]
        self.layers.append({
            "class_name": class_name,
            "name": name,
            "config": cfg,
            "inbound_nodes": [[[i, 0, 0, {}] for i in inbound]],
        })
        if weights:
            self.weights.append((name, weights))
        return name

    def input(self, shape) -> str:
        cfg = {"name": "input_1", "batch_input_shape": [None, *shape],
               "dtype": "float32"}
        self.layers.append({"class_name": "InputLayer", "name": "input_1",
                            "config": cfg, "inbound_nodes": []})
        self._channels = shape[-1]
        return "input_1"

    def conv_bn(self, x: str, filters: int, kh: int, kw: int,
                strides=(1, 1), padding: str = "same",
                in_ch: Optional[int] = None) -> str:
        in_ch = in_ch if in_ch is not None else self._channels
        conv = self._add(
            "Conv2D",
            {"name": self._name("conv2d"), "filters": filters,
             "kernel_size": [kh, kw], "strides": list(strides),
             "padding": padding, "use_bias": False, "activation": "linear"},
            [x], [("kernel:0", (kh, kw, in_ch, filters))])
        bn = self._add(
            "BatchNormalization",
            {"name": self._name("batch_normalization"), "axis": 3,
             "epsilon": 1e-3, "scale": True},
            [conv], [("gamma:0", (filters,)), ("beta:0", (filters,)),
                     ("moving_mean:0", (filters,)),
                     ("moving_variance:0", (filters,))])
        act = self._add("Activation",
                        {"name": self._name("activation"),
                         "activation": "relu"}, [bn])
        self._channels = filters
        return act

    def pool(self, x: str, kind: str, size=(3, 3), strides=(2, 2),
             padding: str = "valid") -> str:
        cls = "MaxPooling2D" if kind == "max" else "AveragePooling2D"
        return self._add(cls, {"name": self._name(kind + "_pooling2d"),
                               "pool_size": list(size),
                               "strides": list(strides),
                               "padding": padding}, [x])

    def concat(self, xs: List[str], channels: int, name: str) -> str:
        out = self._add("Concatenate", {"name": name, "axis": 3}, xs)
        self._channels = channels
        return out


def inception_v3(input_shape=(299, 299, 3), classes: int = 1000):
    """Returns (model_config_json_dict, weight_specs) for InceptionV3.
    weight_specs: list of (layer_name, [(weight_name, shape), ...])."""
    b = _InceptionBuilder()
    x = b.input(input_shape)

    # stem
    x = b.conv_bn(x, 32, 3, 3, strides=(2, 2), padding="valid")
    x = b.conv_bn(x, 32, 3, 3, padding="valid")
    x = b.conv_bn(x, 64, 3, 3)
    x = b.pool(x, "max")
    x = b.conv_bn(x, 80, 1, 1, padding="valid")
    x = b.conv_bn(x, 192, 3, 3, padding="valid")
    x = b.pool(x, "max")

    def mixed_35(x, in_ch, pool_ch, name):
        b._channels = in_ch
        b1 = b.conv_bn(x, 64, 1, 1, in_ch=in_ch)
        b._channels = in_ch
        b5 = b.conv_bn(x, 48, 1, 1, in_ch=in_ch)
        b5 = b.conv_bn(b5, 64, 5, 5)
        b._channels = in_ch
        b3 = b.conv_bn(x, 64, 1, 1, in_ch=in_ch)
        b3 = b.conv_bn(b3, 96, 3, 3)
        b3 = b.conv_bn(b3, 96, 3, 3)
        p = b.pool(x, "avg", strides=(1, 1), padding="same")
        p = b.conv_bn(p, pool_ch, 1, 1, in_ch=in_ch)
        return b.concat([b1, b5, b3, p], 64 + 64 + 96 + pool_ch, name)

    x = mixed_35(x, 192, 32, "mixed0")   # -> 256
    x = mixed_35(x, 256, 64, "mixed1")   # -> 288
    x = mixed_35(x, 288, 64, "mixed2")   # -> 288

    # mixed3: 35x35 -> 17x17 reduction
    in_ch = 288
    b3a = b.conv_bn(x, 384, 3, 3, strides=(2, 2), padding="valid",
                    in_ch=in_ch)
    b._channels = in_ch
    b3b = b.conv_bn(x, 64, 1, 1, in_ch=in_ch)
    b3b = b.conv_bn(b3b, 96, 3, 3)
    b3b = b.conv_bn(b3b, 96, 3, 3, strides=(2, 2), padding="valid")
    p = b.pool(x, "max")
    x = b.concat([b3a, b3b, p], 384 + 96 + 288, "mixed3")  # -> 768

    def mixed_17(x, c7, name):
        in_ch = 768
        b._channels = in_ch
        b1 = b.conv_bn(x, 192, 1, 1, in_ch=in_ch)
        b._channels = in_ch
        b7 = b.conv_bn(x, c7, 1, 1, in_ch=in_ch)
        b7 = b.conv_bn(b7, c7, 1, 7)
        b7 = b.conv_bn(b7, 192, 7, 1)
        b._channels = in_ch
        b77 = b.conv_bn(x, c7, 1, 1, in_ch=in_ch)
        b77 = b.conv_bn(b77, c7, 7, 1)
        b77 = b.conv_bn(b77, c7, 1, 7)
        b77 = b.conv_bn(b77, c7, 7, 1)
        b77 = b.conv_bn(b77, 192, 1, 7)
        p = b.pool(x, "avg", strides=(1, 1), padding="same")
        p = b.conv_bn(p, 192, 1, 1, in_ch=in_ch)
        return b.concat([b1, b7, b77, p], 768, name)

    x = mixed_17(x, 128, "mixed4")
    x = mixed_17(x, 160, "mixed5")
    x = mixed_17(x, 160, "mixed6")
    x = mixed_17(x, 192, "mixed7")

    # mixed8: 17x17 -> 8x8 reduction
    in_ch = 768
    b._channels = in_ch
    b8a = b.conv_bn(x, 192, 1, 1, in_ch=in_ch)
    b8a = b.conv_bn(b8a, 320, 3, 3, strides=(2, 2), padding="valid")
    b._channels = in_ch
    b8b = b.conv_bn(x, 192, 1, 1, in_ch=in_ch)
    b8b = b.conv_bn(b8b, 192, 1, 7)
    b8b = b.conv_bn(b8b, 192, 7, 1)
    b8b = b.conv_bn(b8b, 192, 3, 3, strides=(2, 2), padding="valid")
    p = b.pool(x, "max")
    x = b.concat([b8a, b8b, p], 320 + 192 + 768, "mixed8")  # -> 1280

    def mixed_8x8(x, in_ch, idx):
        b._channels = in_ch
        b1 = b.conv_bn(x, 320, 1, 1, in_ch=in_ch)
        b._channels = in_ch
        b3 = b.conv_bn(x, 384, 1, 1, in_ch=in_ch)
        b3a = b.conv_bn(b3, 384, 1, 3, in_ch=384)
        b._channels = 384
        b3b = b.conv_bn(b3, 384, 3, 1, in_ch=384)
        b3c = b.concat([b3a, b3b], 768, f"mixed9_{idx}")
        b._channels = in_ch
        bd = b.conv_bn(x, 448, 1, 1, in_ch=in_ch)
        bd = b.conv_bn(bd, 384, 3, 3)
        bda = b.conv_bn(bd, 384, 1, 3, in_ch=384)
        b._channels = 384
        bdb = b.conv_bn(bd, 384, 3, 1, in_ch=384)
        bdc = b.concat([bda, bdb], 768, f"concat_{idx}")
        p = b.pool(x, "avg", strides=(1, 1), padding="same")
        p = b.conv_bn(p, 192, 1, 1, in_ch=in_ch)
        return b.concat([b1, b3c, bdc, p], 320 + 768 + 768 + 192,
                        f"mixed{9 + idx}")

    x = mixed_8x8(x, 1280, 0)   # mixed9 -> 2048
    x = mixed_8x8(x, 2048, 1)   # mixed10 -> 2048

    gap = b._add("GlobalAveragePooling2D",
                 {"name": "avg_pool"}, [x])
    pred = b._add("Dense",
                  {"name": "predictions", "units": classes,
                   "activation": "softmax", "use_bias": True},
                  [gap], [("kernel:0", (2048, classes)),
                          ("bias:0", (classes,))])

    cfg = {
        "class_name": "Model",
        "config": {
            "name": "inception_v3",
            "layers": b.layers,
            "input_layers": [["input_1", 0, 0]],
            "output_layers": [[pred, 0, 0]],
        },
    }
    return cfg, b.weights


def write_inception_v3_h5(path: str, input_shape=(299, 299, 3),
                          classes: int = 1000, seed: int = 0) -> dict:
    """Write an InceptionV3 h5 (keras-2 container layout) with random
    He-scaled kernels (normal, variance 2 / fan_in), gamma and moving
    variance 1, beta, moving mean and biases 0. Returns the model_config
    dict."""
    cfg, specs = inception_v3(input_shape, classes)
    rng = np.random.default_rng(seed)
    with hdf5.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        f.attrs["training_config"] = json.dumps(
            {"loss": "categorical_crossentropy"})
        mw = f.require_group("model_weights")
        for layer_name, weights in specs:
            g = mw.require_group(layer_name)
            names = []
            for wname, shape in weights:
                if wname.startswith("kernel"):
                    fan_in = int(np.prod(shape[:-1]))
                    arr = rng.normal(
                        0, (2.0 / max(fan_in, 1)) ** 0.5, shape)
                elif wname.startswith(("gamma", "moving_variance")):
                    arr = np.ones(shape)
                else:
                    arr = np.zeros(shape)
                g.create_dataset(wname, data=arr.astype(np.float32))
                names.append(f"{layer_name}/{wname}".encode())
            g.attrs["weight_names"] = names
    return cfg
