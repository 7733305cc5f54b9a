"""Keras 1.x/2.x HDF5 model import (counterpart of
deeplearning4j_tpu/modelimport/keras.py): a Keras file becomes a port
MultiLayerNetwork (Sequential) or ComputationGraph (functional Model) on
the card, with no user code.

    net = import_keras_model_and_weights("inception_v3.h5")  # on the card
    net = import_keras_model_and_weights(path, device="cpu")

Reference: deeplearning4j-modelimport KerasModelImport.java (entry
points), KerasModel.java (model_config JSON -> network config, weight
copy-in), KerasLayer.java (dispatch by class name) and the per-layer
translators. Files are read with the port's own HDF5 module
(modelimport/hdf5.py).

Keras keeps channels_last layouts: HWIO conv kernels, [in, out] dense
kernels and LSTM gates in (i, f, c, o) order, which are the JAX package's
interchange layouts. Every weight goes into the network through its
layer's `from_interchange` (`interop.layer_params_from_jax`), as float32 on
the network's device, so the port's own layouts (Conv2D's OIHW
channels_last) never meet a Keras array; each array must have the shape of
the slot it fills. BatchNormalization's moving mean and variance become
the vertex's running state.

Every Keras class the JAX importer translates is translated here into the
layer the JAX importer gives; an unknown class raises ValueError.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.modelimport import hdf5
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import (
    ElementWiseVertex,
    GraphVertex,
    LayerVertex,
    MergeVertex,
    PreprocessorVertex,
    ReshapeVertex,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    Activation,
    BatchNorm,
    Conv1D,
    Conv2D,
    Deconv2D,
    Dense,
    DropoutLayer,
    EmbeddingSequence,
    GlobalPooling,
    Output,
    SeparableConv2D,
    SimpleRnn,
    Subsampling1D,
    Subsampling2D,
    Upsampling1D,
    Upsampling2D,
    ZeroPadding1D,
    ZeroPadding2D,
)
from deeplearning4j_tpu_torch.nn.preprocessors import (
    CnnToFeedForward,
    ReshapePreprocessor,
)


_KERAS_ACT = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid",
    "tanh": "tanh", "softmax": "softmax", "elu": "elu", "selu": "selu",
    "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "swish": "swish", "gelu": "gelu",
    "leaky_relu": "leakyrelu", "relu6": "relu6", "exponential": "exp",
}

_KERAS_INIT = {
    "glorot_uniform": "xavier_uniform", "glorot_normal": "xavier",
    "he_normal": "relu", "he_uniform": "relu_uniform",
    "lecun_normal": "lecun_normal", "lecun_uniform": "lecun_uniform",
    "zeros": "zero", "ones": "ones", "uniform": "uniform",
    "normal": "normal", "random_normal": "normal",
    "random_uniform": "uniform", "identity": "identity",
    "varianc_scaling": "var_scaling_normal_fan_in",
    "variance_scaling": "var_scaling_normal_fan_in",
}

_KERAS_LOSS = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "kullback_leibler_divergence": "kld", "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
}


def _act(cfg: dict) -> str:
    a = cfg.get("activation", "linear")
    if isinstance(a, dict):  # keras 3 serialization
        a = a.get("class_name", "linear").lower()
    return _KERAS_ACT.get(a, a)


def _init(cfg: dict, key="kernel_initializer") -> str:
    ini = cfg.get(key, "glorot_uniform")
    if isinstance(ini, dict):
        ini = ini.get("class_name", "glorot_uniform")
    ini = _camel_to_snake(str(ini))
    return _KERAS_INIT.get(ini, "xavier")


def _camel_to_snake(s: str) -> str:
    import re

    return re.sub(r"(?<!^)(?=[A-Z])", "_", s).lower().replace("__", "_")


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _first(v) -> int:
    """An int, or the first of a list of ints (Keras 1-D sizes)."""
    return int(v[0] if isinstance(v, (list, tuple)) else v)


def _pool1d(cfg, pooling_type: str):
    """MaxPooling1D / AveragePooling1D as Subsampling1D."""
    p = _first(cfg.get("pool_size", 2))
    return Subsampling1D(kernel_size=p, stride=_first(cfg.get("strides") or p),
                         pooling_type=pooling_type)


def _padding_mode(cfg) -> str:
    return "same" if cfg.get("padding", "valid") == "same" else "truncate"


def _normalize_keras1(cfg: dict) -> dict:
    """Keras 1.x config keys -> Keras 2 names (the Keras1LayerConfiguration
    role: output_dim/nb_filter/nb_row/border_mode era). No-op on Keras 2
    configs; applied at dispatch so every translator sees one vocabulary."""
    if not any(k in cfg for k in ("output_dim", "nb_filter", "nb_row",
                                  "filter_length", "border_mode",
                                  "subsample", "subsample_length",
                                  "inner_activation")):
        return cfg
    cfg = dict(cfg)
    if "output_dim" in cfg:
        cfg.setdefault("units", cfg["output_dim"])
    if "inner_activation" in cfg:
        cfg.setdefault("recurrent_activation", cfg["inner_activation"])
    if "nb_filter" in cfg:
        cfg.setdefault("filters", cfg["nb_filter"])
    if "nb_row" in cfg and "nb_col" in cfg:
        cfg.setdefault("kernel_size", [cfg["nb_row"], cfg["nb_col"]])
    if "filter_length" in cfg:
        cfg.setdefault("kernel_size", cfg["filter_length"])
    if "border_mode" in cfg:
        cfg.setdefault("padding", cfg["border_mode"])
    if "subsample" in cfg:
        cfg.setdefault("strides", cfg["subsample"])
    if "subsample_length" in cfg:
        cfg.setdefault("strides", cfg["subsample_length"])
    return cfg


class KerasLayerTranslator:
    """class_name -> (port Layer | vertex | marker) translation registry
    (KerasLayer.java's getClassNameXXX dispatch)."""

    def translate(self, class_name: str, cfg: dict):
        cfg = _normalize_keras1(cfg)
        m = getattr(self, f"t_{_camel_to_snake(class_name)}", None)
        if m is None:
            raise ValueError(
                f"Unsupported Keras layer type '{class_name}'. Supported: "
                f"{[n[2:] for n in dir(self) if n.startswith('t_')]}"
            )
        return m(cfg)

    # ---- core ----
    def t_input_layer(self, cfg):
        return ("input", cfg.get("batch_input_shape") or cfg.get("batch_shape"))

    def t_dense(self, cfg):
        return Dense(n_out=int(cfg["units"]), activation=_act(cfg),
                     weight_init=_init(cfg),
                     has_bias=bool(cfg.get("use_bias", True)))

    def t_activation(self, cfg):
        return Activation(activation=_act(cfg))

    def t_leaky_re_l_u(self, cfg):
        # Keras default alpha=0.3 (ours is 0.01): keep the configured slope
        alpha = float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))
        return Activation(activation=f"leakyrelu:{alpha}")

    def t_dropout(self, cfg):
        # keras rate = drop prob; our field stores retain prob (DL4J style),
        # which fit applies as inverted dropout
        return DropoutLayer(dropout=1.0 - float(cfg.get("rate", 0.5)))

    def t_flatten(self, cfg):
        return ("flatten",)

    def t_reshape(self, cfg):
        return ("reshape", cfg.get("target_shape"))

    # ---- conv ----
    def t_conv2_d(self, cfg):
        return Conv2D(
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            dilation=_pair(cfg.get("dilation_rate", 1)),
            n_out=int(cfg["filters"]),
            convolution_mode=_padding_mode(cfg),
            activation=_act(cfg), weight_init=_init(cfg),
            has_bias=bool(cfg.get("use_bias", True)),
        )

    def t_atrous_convolution2_d(self, cfg):
        # keras-1 dilated conv: Conv2D with dilation = atrous_rate
        cfg = dict(cfg)
        cfg.setdefault("dilation_rate", cfg.get("atrous_rate", 1))
        return self.t_conv2_d(cfg)

    def t_atrous_convolution1_d(self, cfg):
        cfg = dict(cfg)
        rate = cfg.get("atrous_rate", cfg.get("dilation_rate", 1))
        rate = rate[0] if isinstance(rate, (list, tuple)) else rate
        out = self.t_conv1_d(cfg)
        out.dilation = int(rate)
        return out

    def t_conv1_d(self, cfg):
        return Conv1D(kernel_size=_first(cfg["kernel_size"]),
                      stride=_first(cfg.get("strides", 1)),
                      n_out=int(cfg["filters"]),
                      convolution_mode=_padding_mode(cfg),
                      activation=_act(cfg), weight_init=_init(cfg),
                      has_bias=bool(cfg.get("use_bias", True)))

    def t_conv2_d_transpose(self, cfg):
        return Deconv2D(
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            n_out=int(cfg["filters"]),
            convolution_mode=_padding_mode(cfg),
            activation=_act(cfg), weight_init=_init(cfg),
            has_bias=bool(cfg.get("use_bias", True)),
        )

    def t_separable_conv2_d(self, cfg):
        return SeparableConv2D(
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            n_out=int(cfg["filters"]),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=_padding_mode(cfg),
            activation=_act(cfg),
            has_bias=bool(cfg.get("use_bias", True)),
        )

    def t_time_distributed(self, cfg):
        # TimeDistributed(inner): per-timestep application is native for
        # Dense-like layers on [b,t,f]; anything else needs real support,
        # so fail loudly instead of silently dropping the wrapper
        inner = cfg.get("layer", {})
        inner_name = inner.get("class_name", "Dense")
        if inner_name not in ("Dense", "Activation", "Dropout"):
            raise ValueError(
                f"TimeDistributed({inner_name}) is not supported; only "
                f"Dense/Activation/Dropout apply per-timestep natively")
        return self.translate(inner_name, dict(inner.get("config", {})))

    def t_time_distributed_dense(self, cfg):
        # keras-1 TimeDistributedDense == per-timestep Dense
        return self.t_dense(cfg)

    # ---- pooling ----
    def t_max_pooling2_d(self, cfg):
        return Subsampling2D(kernel_size=_pair(cfg.get("pool_size", 2)),
                             stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
                             convolution_mode=_padding_mode(cfg),
                             pooling_type="max")

    def t_average_pooling2_d(self, cfg):
        # "same" divides by the full window, padded cells included, as the
        # JAX package's Subsampling2D does (Keras divides by the valid
        # cells; ROADMAP C)
        return Subsampling2D(kernel_size=_pair(cfg.get("pool_size", 2)),
                             stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
                             convolution_mode=_padding_mode(cfg),
                             pooling_type="avg")

    def t_max_pooling1_d(self, cfg):
        return _pool1d(cfg, "max")

    def t_average_pooling1_d(self, cfg):
        return _pool1d(cfg, "avg")

    def t_zero_padding2_d(self, cfg):
        p = cfg.get("padding", 1)
        if isinstance(p, int):
            pad = (p, p, p, p)
        elif isinstance(p[0], (list, tuple)):
            pad = (p[0][0], p[0][1], p[1][0], p[1][1])
        else:
            pad = (p[0], p[0], p[1], p[1])
        return ZeroPadding2D(pad=pad)

    def t_zero_padding1_d(self, cfg):
        p = cfg.get("padding", 1)
        return ZeroPadding1D(pad=p if isinstance(p, int) else tuple(p))

    def t_up_sampling2_d(self, cfg):
        return Upsampling2D(size=_pair(cfg.get("size", 2)))

    def t_up_sampling1_d(self, cfg):
        return Upsampling1D(size=_first(cfg.get("size", 2)))

    def t_global_max_pooling2_d(self, cfg):
        return GlobalPooling(pooling_type="max")

    def t_global_average_pooling2_d(self, cfg):
        return GlobalPooling(pooling_type="avg")

    def t_global_max_pooling1_d(self, cfg):
        return GlobalPooling(pooling_type="max")

    def t_global_average_pooling1_d(self, cfg):
        return GlobalPooling(pooling_type="avg")

    # ---- norm / embed / recurrent ----
    def t_batch_normalization(self, cfg):
        bn = BatchNorm(decay=float(cfg.get("momentum", 0.99)),
                       eps=float(cfg.get("epsilon", 1e-3)))
        # scale=False / center=False shift the h5 weight list; remember the
        # flags for _set_layer_weights / _bn_state
        bn._keras_scale = bool(cfg.get("scale", True))
        bn._keras_center = bool(cfg.get("center", True))
        return bn

    def t_embedding(self, cfg):
        return EmbeddingSequence(n_in=int(cfg["input_dim"]),
                                 n_out=int(cfg["output_dim"]),
                                 has_bias=False)

    def t_l_s_t_m(self, cfg):
        return LSTM(n_out=int(cfg["units"]), activation=_act(cfg),
                    gate_activation=_KERAS_ACT.get(
                        cfg.get("recurrent_activation", "sigmoid"), "sigmoid"),
                    forget_gate_bias_init=1.0 if cfg.get("unit_forget_bias", True) else 0.0)

    def t_simple_r_n_n(self, cfg):
        return SimpleRnn(n_out=int(cfg["units"]), activation=_act(cfg))

    # ---- merges ----
    def t_add(self, cfg):
        return ElementWiseVertex(op="add")

    def t_subtract(self, cfg):
        return ElementWiseVertex(op="subtract")

    def t_multiply(self, cfg):
        return ElementWiseVertex(op="product")

    def t_average(self, cfg):
        return ElementWiseVertex(op="average")

    def t_maximum(self, cfg):
        return ElementWiseVertex(op="max")

    def t_concatenate(self, cfg):
        return MergeVertex()

    def t_merge(self, cfg):  # keras 1 legacy
        mode = cfg.get("mode", "concat")
        if mode == "concat":
            return MergeVertex()
        ops = {"sum": "add", "mul": "product", "ave": "average",
               "max": "max"}
        if mode not in ops:
            raise ValueError(f"Unsupported legacy Merge mode '{mode}'")
        return ElementWiseVertex(op=ops[mode])


# keras-1 class names (Keras1LayerConfiguration vocabulary): Convolution2D
# etc.; field renames are handled by _normalize_keras1
KerasLayerTranslator.t_convolution2_d = KerasLayerTranslator.t_conv2_d
KerasLayerTranslator.t_convolution1_d = KerasLayerTranslator.t_conv1_d
KerasLayerTranslator.t_deconvolution2_d = \
    KerasLayerTranslator.t_conv2_d_transpose

_TRANSLATOR = KerasLayerTranslator()


def _input_type_from_shape(shape, channels_first: bool = False):
    """batch_input_shape (with leading None) -> InputType.

    Returns None when the shape is fully unspecified ([None, None] — a
    variable-length id sequence into an Embedding; the caller infers
    recurrent(vocab, -1) from the embedding layer instead).
    `channels_first` maps th/channels_first conv shapes [c, h, w] onto
    the framework's NHWC InputType (the reference converts th-ordering
    models the analogous way)."""
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return it.feed_forward(dims[0]) if dims[0] else None
    if len(dims) == 2:
        return it.recurrent(dims[1], dims[0] or -1) if dims[1] else None
    if len(dims) == 3:
        if channels_first:
            return it.convolutional(dims[1], dims[2], dims[0])
        return it.convolutional(dims[0], dims[1], dims[2])
    raise ValueError(f"Unsupported input shape {shape}")


def _channels_first(cfg: dict) -> bool:
    return (cfg.get("data_format") == "channels_first"
            or cfg.get("dim_ordering") == "th")


# ---------------------------------------------------------------------------
# weight copy-in
# ---------------------------------------------------------------------------


def _weight_sort_rank(name: str, i: int):
    """Canonical order for weight datasets found by group walk: kernel
    before recurrent before bias, BN stats in gamma/beta/mean/var order.
    Handles both keras2 names ('kernel:0') and keras1 / TF-scoped names
    ('global/shared/dense_1_W:0', '..._U:0', '..._b:0' — the tfscope
    fixtures' spelling, KerasModelImportTest.java:38-59)."""
    base = name.split("/")[-1].split(":")[0]
    rank = {"depthwise_kernel": 0, "kernel": 0, "gamma": 0,
            "pointwise_kernel": 1, "recurrent_kernel": 1, "beta": 1,
            "bias": 2, "moving_mean": 2, "moving_variance": 3}
    if base in rank:
        return (rank[base], i)
    kind = {"W": 0, "U": 1, "b": 2}
    parts = base.rsplit("_", 1)
    # keras1 per-gate LSTM names (lstm_1_W_i etc.): reproduce the
    # weight_names order the 12-weight consumer indexes into —
    # gate-major (i, c, f, o), (W, U, b) triples within each gate
    if len(parts) == 2 and parts[1] in ("i", "c", "f", "o") \
            and "_" in parts[0]:
        head = parts[0].rsplit("_", 1)[1]
        if head in kind:
            gate = {"i": 0, "c": 1, "f": 2, "o": 3}[parts[1]]
            return (gate * 3 + kind[head], i)
    # keras1 suffix convention: <layer>_W / _U / _b
    if len(parts) == 2 and parts[1] in kind:
        return (50 + kind[parts[1]], i)
    return (100 + i, i)


def _layer_weight_group(f, layer_name: str):
    """The arrays of one layer's weight group, in Keras's order: by the
    group's `weight_names`, else every dataset below it in canonical
    order (`_weight_sort_rank`). None when the file has no such group."""
    mw = f["model_weights"] if "model_weights" in f else f
    # TF-scoped layer names contain '/' (e.g. 'dense_1/xxx/yyy'): the path
    # resolves into the nested groups directly
    if layer_name not in mw:
        return None
    g = mw[layer_name]
    names = g.attrs.get("weight_names")
    if names is not None and len(names):
        out = []
        for n in np.ravel(names):
            n = n.decode() if isinstance(n, bytes) else str(n)
            # weight_names are paths relative to the layer group or to
            # model_weights ("dense_1/kernel:0")
            if n in g:
                out.append(np.asarray(g[n]))
            elif n in mw:
                out.append(np.asarray(mw[n]))
            else:
                raise KeyError(f"weight '{n}' not found for layer {layer_name}")
        return out
    # no weight_names (TF-scoped layer groups lack it): every dataset,
    # ordered canonically, since the walk is alphabetical and would put
    # bias:0 before kernel:0
    found = []

    def visit(name, obj):
        if isinstance(obj, hdf5.Dataset):
            found.append((name, np.asarray(obj)))

    g.visititems(visit)
    keyed = [(_weight_sort_rank(name, i), arr)
             for i, (name, arr) in enumerate(found)]
    keyed.sort(key=lambda x: x[0])
    return [arr for _, arr in keyed]


def _set_layer_weights(layer, params: dict, w: List[np.ndarray]) -> dict:
    """Map the Keras weight list onto a layer's param dict, both in the
    interchange layout (the JAX package's rules, per layer type)."""
    t = type(layer).__name__
    if not w:
        return params
    params = dict(params)
    if t in ("Dense", "Output", "Conv2D", "Conv1D", "Deconv2D",
             "EmbeddingSequence", "RnnOutput"):
        params["W"] = w[0]
        if t == "Conv1D" and w[0].ndim == 3:
            # keras conv1d kernel [k, cin, cout] -> [k, 1, cin, cout]
            params["W"] = w[0][:, None, :, :]
        if t == "Deconv2D" and w[0].ndim == 4:
            # keras Conv2DTranspose kernel [kh, kw, cout, cin] -> HWIO
            params["W"] = np.transpose(w[0], (0, 1, 3, 2))
        if len(w) > 1 and "b" in params:
            params["b"] = w[1]
    elif t == "SeparableConv2D":
        # keras depthwise kernel [kh, kw, cin, dm] -> the grouped conv's
        # [kh, kw, 1, cin * dm]
        kh, kw, cin, dm = w[0].shape
        params["dW"] = w[0].reshape(kh, kw, 1, cin * dm)
        params["pW"] = w[1]
        if len(w) > 2 and "b" in params:
            params["b"] = w[2]
    elif t == "BatchNorm":
        # keras order: [gamma if scale] [beta if center] mean var
        i = 0
        if getattr(layer, "_keras_scale", True) and "gamma" in params:
            params["gamma"] = w[i]
            i += 1
        if getattr(layer, "_keras_center", True) and "beta" in params:
            params["beta"] = w[i]
    elif t in ("LSTM", "GravesLSTM"):
        if len(w) == 12:
            # keras-1 per-gate layout: W_i U_i b_i, W_c U_c b_c, W_f U_f
            # b_f, W_o U_o b_o -> fused [*, 4n] in our gate order i,f,g,o
            order = (0, 6, 3, 9)  # i, f, c(=g), o triple offsets
            params["W"] = np.concatenate([w[k] for k in order], axis=-1)
            params["R"] = np.concatenate([w[k + 1] for k in order], axis=-1)
            if "b" in params:
                params["b"] = np.concatenate([w[k + 2] for k in order])
        else:
            params["W"] = w[0]   # [in, 4n] gates (i, f, c=g, o)
            params["R"] = w[1]
            if len(w) > 2:
                params["b"] = w[2]
    elif t == "SimpleRnn":
        params["W"], params["R"] = w[0], w[1]
        if len(w) > 2:
            params["b"] = w[2]
    return params


def _bn_state(weights: List[np.ndarray], layer) -> Optional[dict]:
    """BatchNormalization's moving mean and variance, or None when the
    weight list has none."""
    n_affine = (int(getattr(layer, "_keras_scale", True))
                + int(getattr(layer, "_keras_center", True)))
    if len(weights) >= n_affine + 2:
        return {"mean": weights[n_affine], "var": weights[n_affine + 1]}
    return None


def _copy_in(net, key: str, layer, weights: List[np.ndarray]) -> None:
    """One layer's Keras arrays into `net` under `key`: params through the
    layer's interchange hooks onto the network's device, BatchNorm's
    moving statistics into its running state. Raises when an array does
    not have the shape of the slot it fills."""
    have = {k: layer.to_interchange(k, t).detach().cpu().numpy()
            for k, t in net.params[key].items()}
    new = _set_layer_weights(layer, have, weights)
    st = _bn_state(weights, layer) if isinstance(layer, BatchNorm) else None
    for kind, cur, got in (("param", have, new),
                           ("state", net.state[key], st or {})):
        for k, arr in got.items():
            if tuple(np.shape(arr)) != tuple(cur[k].shape):
                raise ValueError(
                    f"Keras weights of layer {key!r} ({type(layer).__name__})"
                    f": {kind} {k!r} has shape {tuple(np.shape(arr))}, the "
                    f"network's is {tuple(cur[k].shape)}")
    net.params[key] = interop.layer_params_from_jax(layer, new, net.device)
    if st is not None:
        net.state[key] = {k: torch.from_numpy(np.array(v, np.float32)).to(
            net.device) for k, v in st.items()}


# ---------------------------------------------------------------------------
# entry points (KerasModelImport.java:309)
# ---------------------------------------------------------------------------


def _sequential_net_from_cfg(cfg, training_cfg, device):
    """Parsed Sequential model_config dict -> (net, layers, names) on
    `device`.

    Shared by the h5 path, the json+weights pair path
    (KerasModelImport.importKerasSequentialModelAndWeights(json, weights))
    and the config-only path (importKerasSequentialConfiguration)."""
    assert cfg["class_name"] == "Sequential", "not a Sequential model"
    layer_cfgs = cfg["config"]
    if isinstance(layer_cfgs, dict):
        layer_cfgs = layer_cfgs["layers"]

    layers = []
    names = []
    input_type = None
    pending_preprocessors = {}  # layer index -> InputPreProcessor
    for lc in layer_cfgs:
        cname, lcfg = lc["class_name"], lc["config"]
        if input_type is None and not layers:
            shape = lcfg.get("batch_input_shape") or lcfg.get("batch_shape")
            if shape is not None:
                input_type = _input_type_from_shape(
                    shape, _channels_first(lcfg))
        tr = _TRANSLATOR.translate(cname, lcfg)
        if isinstance(tr, tuple):  # input/flatten/reshape markers
            if tr[0] == "input" and tr[1] is not None:
                input_type = _input_type_from_shape(
                    tr[1], _channels_first(lcfg))
            elif tr[0] == "reshape" and tr[1] is not None:
                pending_preprocessors[len(layers)] = \
                    ReshapePreprocessor(target_shape=tuple(tr[1]))
            # flatten needs no preprocessor: Dense flattens CNN input
            continue
        tr.name = lcfg.get("name")
        layers.append(tr)
        names.append(lcfg.get("name"))

    # the common Keras idiom Dense(linear) -> Activation(softmax) at the
    # network end: fold the activation into the Dense so the Output
    # conversion below sees one trailing classifier layer. Only when the
    # Dense is linear: Dense(tanh) -> Activation(softmax) composes two
    # nonlinearities and must stay two layers
    if (len(layers) >= 2 and isinstance(layers[-1], Activation)
            and isinstance(layers[-2], Dense)
            and not isinstance(layers[-2], Output)
            and (layers[-2].activation or "identity") == "identity"):
        act = layers.pop().activation
        names.pop()
        layers[-1].activation = act

    # convert trailing Dense into Output with the training loss
    loss = _KERAS_LOSS.get((training_cfg or {}).get("loss"), None)
    if layers and isinstance(layers[-1], Dense) and not isinstance(layers[-1], Output):
        last = layers[-1]
        layers[-1] = Output(n_out=last.n_out, activation=last.activation,
                            weight_init=last.weight_init,
                            has_bias=last.has_bias, name=last.name,
                            loss=loss or "mcxent")

    if input_type is None and layers and \
            isinstance(layers[0], EmbeddingSequence):
        # [None, None] id-sequence input: the embedding layer carries the
        # vocabulary size, length stays dynamic
        input_type = it.recurrent(layers[0].n_in, -1)

    conf = NeuralNetConfiguration(seed=0).list(layers)
    for idx, pre in pending_preprocessors.items():
        conf.input_preprocessor(idx, pre)
    if input_type is not None:
        conf.set_input_type(input_type)
    net = MultiLayerNetwork(conf.build()).init(device)
    return net, layers, names


def _copy_sequential_weights(f, net, layers, names):
    for i, (layer, name) in enumerate(zip(layers, names)):
        w = _layer_weight_group(f, name)
        if w:
            _copy_in(net, f"layer_{i}", layer, w)


def import_keras_sequential_model_and_weights(path, weights_path=None,
                                              enforce_training_config=False,
                                              device=None):
    """Sequential h5 -> MultiLayerNetwork on `device` (None: the card).
    With `weights_path`, `path` is a model-architecture JSON file and the
    weights come from a separate weights-only h5, the reference's two-file
    entry point (KerasModelImport.importKerasSequentialModelAndWeights(
    modelJson, weightsPath))."""
    if isinstance(weights_path, bool):
        # pre-two-file signature: enforce_training_config passed
        # positionally
        enforce_training_config, weights_path = weights_path, None

    if weights_path is not None or str(path).endswith(".json"):
        with open(path) as jf:
            cfg = json.load(jf)
        net, layers, names = _sequential_net_from_cfg(cfg, None, device)
        if weights_path is not None:
            with hdf5.File(weights_path) as f:
                _copy_sequential_weights(f, net, layers, names)
        return net

    with hdf5.File(path) as f:
        cfg = _model_config(f)
        training_cfg = _training_config(f)
        net, layers, names = _sequential_net_from_cfg(cfg, training_cfg,
                                                      device)
        _copy_sequential_weights(f, net, layers, names)
    return net


def import_keras_sequential_configuration(path, device=None):
    """Architecture-only JSON -> MultiLayerNetwork with fresh weights
    (KerasModelImport.importKerasSequentialConfiguration)."""
    with open(path) as jf:
        cfg = json.load(jf)
    net, _, _ = _sequential_net_from_cfg(cfg, None, device)
    return net


def import_keras_model_configuration(path, device=None):
    """Architecture-only JSON -> ComputationGraph (functional Model) or
    MultiLayerNetwork (Sequential) with fresh weights
    (KerasModelImport.importKerasModelConfiguration)."""
    with open(path) as jf:
        cfg = json.load(jf)
    if cfg["class_name"] == "Sequential":
        net, _, _ = _sequential_net_from_cfg(cfg, None, device)
        return net
    net, _ = _graph_net_from_cfg(cfg, None, device)
    return net


def _graph_net_from_cfg(cfg, training_cfg, device):
    """Parsed functional model_config dict -> (net, layer_objs) on
    `device`."""
    mcfg = cfg["config"]
    g = NeuralNetConfiguration(seed=0).graph()
    output_names = [ln[0] for ln in mcfg["output_layers"]]
    input_types = []
    layer_objs = {}

    for lc in mcfg["layers"]:
        cname, lcfg, name = lc["class_name"], lc["config"], lc["name"]
        inbound = lc.get("inbound_nodes") or []
        in_names = _inbound_names(inbound)
        if cname == "InputLayer":
            g.add_inputs(name)
            shape = lcfg.get("batch_input_shape") or lcfg.get("batch_shape")
            input_types.append(_input_type_from_shape(
                shape, _channels_first(lcfg)))
            continue
        tr = _TRANSLATOR.translate(cname, lcfg)
        if isinstance(tr, tuple):
            if tr[0] == "flatten":
                g.add_vertex(name, PreprocessorVertex(
                    preprocessor=CnnToFeedForward()), *in_names)
                continue
            if tr[0] == "reshape":
                g.add_vertex(name, ReshapeVertex(new_shape=tr[1]), *in_names)
                continue
            raise ValueError(f"marker {tr} in functional model")
        if isinstance(tr, GraphVertex):
            g.add_vertex(name, tr, *in_names)
        else:
            tr.name = name
            g.add_layer(name, tr, *in_names)
            layer_objs[name] = tr

    # last output layer: convert Dense to Output
    loss = _KERAS_LOSS.get((training_cfg or {}).get("loss"), "mcxent")
    for oname in output_names:
        v = g.vertices.get(oname)
        if isinstance(v, LayerVertex) and isinstance(v.layer, Dense) and \
                not isinstance(v.layer, Output):
            old = v.layer
            v.layer = Output(n_out=old.n_out, activation=old.activation,
                             weight_init=old.weight_init,
                             has_bias=old.has_bias, name=old.name,
                             loss=loss)
            layer_objs[oname] = v.layer
    g.set_outputs(*output_names)
    g.set_input_types(*input_types)
    net = ComputationGraph(g.build()).init(device)
    return net, layer_objs


def import_keras_model_and_weights(path, enforce_training_config=False,
                                   device=None):
    """Functional Model h5 -> ComputationGraph on `device` (None: the
    card); a Sequential file gives a MultiLayerNetwork."""
    with hdf5.File(path) as f:
        cfg = _model_config(f)
    if cfg["class_name"] == "Sequential":
        return import_keras_sequential_model_and_weights(path, device=device)
    with hdf5.File(path) as f:
        net, layer_objs = _graph_net_from_cfg(cfg, _training_config(f),
                                              device)
        for name, layer in layer_objs.items():
            w = _layer_weight_group(f, name)
            if w:
                _copy_in(net, name, layer, w)
    return net


def _inbound_names(inbound) -> List[str]:
    if not inbound:
        return []
    node = inbound[0]
    # keras2: [[["name", 0, 0, {}], ...]]; keras3: {"args": [...]}
    if isinstance(node, dict):
        args = node.get("args", [])
        names = []

        def walk(o):
            if isinstance(o, dict) and "config" in o and "keras_history" in o.get("config", {}):
                names.append(o["config"]["keras_history"][0])
            elif isinstance(o, (list, tuple)):
                for x in o:
                    walk(x)

        walk(args)
        return names
    return [n[0] for n in node]


def _model_config(f) -> dict:
    raw = f.attrs.get("model_config")
    if raw is None:
        raise ValueError("h5 file has no model_config attribute")
    if isinstance(raw, bytes):
        raw = raw.decode()
    return json.loads(raw)


def _training_config(f) -> Optional[dict]:
    raw = f.attrs.get("training_config")
    if raw is None:
        return None
    if isinstance(raw, bytes):
        raw = raw.decode()
    return json.loads(raw)


class KerasModelImport:
    """Static facade mirroring KerasModelImport.java entry points."""

    importKerasModelAndWeights = staticmethod(import_keras_model_and_weights)
    importKerasSequentialModelAndWeights = staticmethod(
        import_keras_sequential_model_and_weights)
    importKerasModelConfiguration = staticmethod(
        import_keras_model_configuration)
    importKerasSequentialConfiguration = staticmethod(
        import_keras_sequential_configuration)
