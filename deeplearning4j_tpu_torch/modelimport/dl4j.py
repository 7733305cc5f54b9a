"""DL4J ModelSerializer zip import (counterpart of
deeplearning4j_tpu/modelimport/dl4j.py): a zip written by DL4J's
`ModelSerializer.writeModel` (util/ModelSerializer.java:39-148), as early
stopping, the Spark masters, the CLI and the DL4J zoo save models, becomes a
port MultiLayerNetwork or ComputationGraph on the card, with its updater
state and normalizer.

    net = restore_multi_layer_network("char_rnn.zip", load_updater=True)
    net = restore_multi_layer_network(path, device="cpu")

The zip holds `configuration.json` (jackson MultiLayerConfiguration or
ComputationGraphConfiguration), `coefficients.bin` (the network's single
flat parameter vector, Nd4j.write) and optionally `updaterState.bin` and
`normalizer.bin`. Everything here is a file format, so it is numpy and the
standard library; tensors appear only where an array enters the network.

Format facts, pinned to reference code:
  * Nd4j.write: two DataBuffers (shape info, then data), each
    `writeUTF(allocationMode) writeInt(length) writeUTF(dataType)` and
    big-endian elements; shape info = [rank, shape.., stride.., offset,
    ews, order-char]. FLOAT, DOUBLE, INT, LONG and HALF decode; COMPRESSED
    buffers refuse with a diagnostic.
  * configuration.json layer typing: WRAPPER_OBJECT with per-type names
    ("dense", "output", "convolution", ... nn/conf/layers/Layer.java:48-75);
    legacy per-layer updater fields and `activationFunction` /
    `lossFunction` strings, or the typed `activationFn` / `lossFn` /
    `iUpdater` objects (BaseNetConfigDeserializer.java:101-170).
  * The flat vector is per layer, in layer order (MultiLayerNetwork) or in
    the reference's FIFO Kahn order (ComputationGraph, which the port's
    own topological order need not match), each layer per its
    ParamInitializer:
      - Dense/Output/Embedding: W (nIn x nOut, 'f' order), then b;
      - Convolution: b FIRST, then W in 'c' order [nOut, nIn, kh, kw];
      - BatchNorm: gamma, beta (absent with lockGammaBeta), mean, var;
      - LSTM/GravesLSTM: iW [nIn, 4n] 'f', rW [n, 4n (+3 peephole
        columns f, o, i)] 'f', b [4n]; gate blocks (g, f, o, i), which the
        port's cell holds as (i, f, g, o).
  * updaterState.bin follows the same walk: consecutive (layer, variable)
    pairs with the same updater form one block whose slots are contiguous
    ([m, v] for Adam); BatchNorm's mean and var carry a NoOp updater, so
    every BatchNorm ends a block (BaseMultiLayerUpdater.java:38-120).

Every array is sliced into the interchange layout (the JAX package's: HWIO
conv kernels, (i, f, g, o) gates) and goes into the network through its
layer's `from_interchange` (`interop.layer_params_from_jax`), float32 on the
network's device; BatchNorm's mean and var become its running state.
A vertex type neither importer translates raises ValueError. Like the JAX
importer, DuplicateToTimeSeriesVertex is translated with no fields: the
reference's one-input vertex names its time source by `inputName`, which
both importers drop (ROADMAP C.10).
"""
from __future__ import annotations

import io
import json
import struct
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import graph_vertices as gv
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import preprocessors as pp
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

PEEPHOLE_COLS = 3  # rW trailing columns: f, o, i peepholes (Graves only)


# --------------------------------------------------------------------------
# Nd4j binary array format
# --------------------------------------------------------------------------
def _read_utf(f) -> str:
    (n,) = struct.unpack(">H", f.read(2))
    return f.read(n).decode("utf-8")


def _write_utf(f, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack(">H", len(b)))
    f.write(b)


_DTYPES = {"FLOAT": (">f4", 4), "DOUBLE": (">f8", 8), "INT": (">i4", 4),
           "LONG": (">i8", 8), "HALF": (">f2", 2)}


def _read_buffer(f) -> np.ndarray:
    """One nd4j DataBuffer: writeUTF(allocMode) writeInt(len)
    writeUTF(dtype), then big-endian elements. COMPRESSED buffers (models
    saved with Nd4j compression active) carry codec payloads this reader
    does not decode and fail with an actionable message."""
    alloc = _read_utf(f)
    if alloc not in ("HEAP", "DIRECT", "JAVACPP", "LONG_SHAPE",
                     "MIXED_DATA_TYPES"):
        raise ValueError(f"not an nd4j DataBuffer (allocation mode "
                         f"{alloc!r})")
    (length,) = struct.unpack(">i", f.read(4))
    dtype = _read_utf(f)
    if dtype == "COMPRESSED":
        raise ValueError(
            "nd4j COMPRESSED DataBuffer: this model was saved with Nd4j "
            "compression enabled; re-save it uncompressed "
            "(Nd4j.getCompressor().decompressi(arr) before writing, or "
            "save from a session without compression) and import again")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported nd4j dtype {dtype!r} (supported: "
                         f"{sorted(_DTYPES)})")
    np_dtype, size = _DTYPES[dtype]
    raw = f.read(length * size)
    if len(raw) != length * size:
        raise ValueError("truncated nd4j buffer")
    return np.frombuffer(raw, np_dtype).astype(
        np.float32 if dtype == "HALF" else np_dtype, copy=True)


def read_nd4j_array(f) -> np.ndarray:
    """Nd4j.write format: the shape-info int buffer, then the data buffer;
    float32, in the stored order."""
    shape_info = _read_buffer(f).astype(np.int64)
    rank = int(shape_info[0])
    shape = tuple(int(s) for s in shape_info[1:1 + rank])
    order = chr(int(shape_info[-1]))
    data = _read_buffer(f).astype(np.float32)
    if int(np.prod(shape)) != data.size:
        raise ValueError(f"shape {shape} does not match {data.size} elements")
    return np.reshape(data, shape, order="F" if order == "f" else "C")


def write_nd4j_array(f, arr: np.ndarray, order: str = "c",
                     dtype: str = "FLOAT") -> None:
    """Inverse of read_nd4j_array, in the reference layout; `dtype` picks
    the element encoding (FLOAT, HALF or DOUBLE)."""
    arr = np.asarray(arr, np.float32)
    rank = arr.ndim
    stride = [1] * rank
    if order == "c":
        for i in range(rank - 2, -1, -1):
            stride[i] = stride[i + 1] * arr.shape[i + 1]
    else:
        for i in range(1, rank):
            stride[i] = stride[i - 1] * arr.shape[i - 1]
    info = [rank, *arr.shape, *stride, 0, 1, ord(order)]
    _write_utf(f, "HEAP")
    f.write(struct.pack(">i", len(info)))
    _write_utf(f, "INT")
    f.write(np.asarray(info, ">i4").tobytes())
    _write_utf(f, "HEAP")
    f.write(struct.pack(">i", arr.size))
    _write_utf(f, dtype)
    np_dt = {"FLOAT": ">f4", "HALF": ">f2", "DOUBLE": ">f8"}[dtype]
    f.write(arr.ravel(order="C" if order == "c" else "F").astype(np_dt)
            .tobytes())


# --------------------------------------------------------------------------
# configuration.json -> port configuration
# --------------------------------------------------------------------------
_ACTIVATION_ALIASES = {
    "relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh", "softmax":
    "softmax", "identity": "identity", "softplus": "softplus", "softsign":
    "softsign", "elu": "elu", "leakyrelu": "leakyrelu", "hardtanh":
    "hardtanh", "hardsigmoid": "hardsigmoid", "cube": "cube",
    "rationaltanh": "rationaltanh", "rectifiedtanh": "rectifiedtanh",
    "selu": "selu", "swish": "swish",
}


def _activation_from(node: dict) -> Optional[str]:
    """Every serde generation: pre-0.7.2 `activationFunction` strings, the
    `activationFn` WRAPPER_OBJECT ({"ReLU": {}}) and @class-typed objects
    (MultiLayerConfiguration.java:229-255)."""
    if "activationFunction" in node:
        raw = str(node["activationFunction"])
    elif "activationFn" in node:
        fn = node["activationFn"]
        if isinstance(fn, str):
            raw = fn
        elif isinstance(fn, dict):
            if "@class" in fn:
                raw = fn["@class"].rsplit(".", 1)[-1]
                raw = raw[len("Activation"):] if raw.startswith("Activation") \
                    else raw
            elif len(fn) == 1:
                raw = next(iter(fn))
            else:
                raise ValueError(f"unrecognized activationFn {fn!r}")
        else:
            raise ValueError(f"unrecognized activationFn {fn!r}")
    else:
        return None
    key = raw.lower().replace("_", "")
    if key not in _ACTIVATION_ALIASES:
        raise ValueError(f"unknown DL4J activation {raw!r}")
    return _ACTIVATION_ALIASES[key]


def _loss_from(node: dict) -> Optional[str]:
    """The lossFunction enum string (legacy, MultiLayerConfiguration.java
    :180) or a typed lossFn object."""
    if "lossFunction" in node and node["lossFunction"] is not None:
        return str(node["lossFunction"]).lower()
    fn = node.get("lossFn")
    if fn is None:
        return None
    if isinstance(fn, str):
        name = fn
    elif "@class" in fn:
        name = fn["@class"].rsplit(".", 1)[-1]
        name = name[len("Loss"):] if name.startswith("Loss") else name
    elif len(fn) == 1:
        name = next(iter(fn))
    else:
        raise ValueError(f"unrecognized lossFn {fn!r}")
    key = name.lower()
    return {"binaryxent": "xent"}.get(key, key)


def _updater_from(node: dict):
    """The legacy per-layer updater enum and hyperparameter fields
    (BaseNetConfigDeserializer.java:101-170) or a typed iUpdater object."""
    iu = node.get("iUpdater")
    if isinstance(iu, dict):
        if "@class" in iu:
            name = iu["@class"].rsplit(".", 1)[-1].lower()
        elif len(iu) == 1 and isinstance(next(iter(iu.values())), dict):
            # WRAPPER_OBJECT spelling {"Adam": {...}}: the hyperparameters
            # are in the nested body
            name, iu = next(iter(iu.items()))
            name = name.lower()
        else:
            raise ValueError(f"unrecognized iUpdater {iu!r}")
        lr = float(iu.get("learningRate", 1e-1))
        if name == "nesterovs":
            return upd.Nesterovs(learning_rate=lr,
                                 momentum=float(iu.get("momentum", 0.9)))
        if name == "adam":
            return upd.Adam(learning_rate=lr,
                            beta1=float(iu.get("beta1", 0.9)),
                            beta2=float(iu.get("beta2", 0.999)))
        if name == "sgd":
            return upd.Sgd(learning_rate=lr)
        if name == "rmsprop":
            return upd.RmsProp(learning_rate=lr,
                               rms_decay=float(iu.get("rmsDecay", 0.95)))
        raise ValueError(f"unsupported iUpdater {iu!r}")
    name = node.get("updater")
    if name is None:
        return None
    lr = float(node.get("learningRate", 1e-1))
    name = name.upper()
    if name == "NESTEROVS":
        return upd.Nesterovs(learning_rate=lr,
                             momentum=float(node.get("momentum", 0.9)))
    if name == "SGD":
        return upd.Sgd(learning_rate=lr)
    if name == "ADAM":
        return upd.Adam(learning_rate=lr,
                        beta1=float(node.get("adamMeanDecay", 0.9)),
                        beta2=float(node.get("adamVarDecay", 0.999)))
    if name == "RMSPROP":
        return upd.RmsProp(learning_rate=lr,
                           rms_decay=float(node.get("rmsDecay", 0.95)))
    if name == "ADAGRAD":
        return upd.AdaGrad(learning_rate=lr)
    if name == "ADADELTA":
        return upd.AdaDelta(rho=float(node.get("rho", 0.95)))
    if name in ("NONE", "CUSTOM"):
        return None
    raise ValueError(f"unsupported legacy updater {name!r}")


def _get_ni(node: dict, *names, default=None):
    for n in names:
        if n in node and node[n] is not None:
            return node[n]
    return default


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v[:2])
    return (int(v), int(v))


def _common_kwargs(node: dict) -> dict:
    kw = {}
    act = _activation_from(node)
    if act is not None:
        kw["activation"] = act
    wi = node.get("weightInit")
    if wi:
        kw["weight_init"] = str(wi).lower()
    if node.get("biasInit") not in (None, 0.0):
        kw["bias_init"] = float(node["biasInit"])
    for src, dst in (("l1", "l1"), ("l2", "l2"), ("l1Bias", "l1_bias"),
                     ("l2Bias", "l2_bias")):
        v = node.get(src)
        if v and not (isinstance(v, float) and np.isnan(v)):
            kw[dst] = float(v)
    u = _updater_from(node)
    if u is not None:
        kw["updater"] = u
    # training semantics: dropping these would fine-tune with other
    # regularization than the reference net had (a float dropOut is the
    # retain probability, which fit applies as Dropout(p))
    drop = node.get("dropOut")
    if drop not in (None, 0, 0.0, 1.0):
        kw["dropout"] = float(drop)
    gn = node.get("gradientNormalization")
    if gn and gn != "None":
        kw["gradient_normalization"] = str(gn)
        thr = node.get("gradientNormalizationThreshold")
        if thr is not None:
            kw["gradient_normalization_threshold"] = float(thr)
    name = node.get("layerName")
    if name:
        kw["name"] = name
    return kw


def _translate_layer(type_name: str, node: dict):
    kw = _common_kwargs(node)
    n_in = _get_ni(node, "nin", "nIn")
    n_out = _get_ni(node, "nout", "nOut")
    if type_name == "dense":
        return L.Dense(n_in=n_in, n_out=n_out, **kw)
    if type_name == "output":
        return L.Output(n_in=n_in, n_out=n_out, loss=_loss_from(node), **kw)
    if type_name == "rnnoutput":
        return L.RnnOutput(n_in=n_in, n_out=n_out, loss=_loss_from(node),
                           **kw)
    if type_name == "loss":
        return L.LossLayer(loss=_loss_from(node), **kw)
    if type_name == "embedding":
        return L.Embedding(n_in=n_in, n_out=n_out,
                           has_bias=bool(node.get("hasBias", True)), **kw)
    if type_name == "convolution":
        return L.Conv2D(
            n_in=n_in, n_out=n_out,
            kernel_size=_pair(node.get("kernelSize", (1, 1))),
            stride=_pair(node.get("stride", (1, 1))),
            padding=_pair(node.get("padding", (0, 0))),
            dilation=_pair(node.get("dilation", (1, 1))),
            convolution_mode=str(node.get("convolutionMode",
                                          "Truncate")).lower(),
            has_bias=bool(node.get("hasBias", True)), **kw)
    if type_name == "subsampling":
        return L.Subsampling2D(
            kernel_size=_pair(node.get("kernelSize", (2, 2))),
            stride=_pair(node.get("stride", (2, 2))),
            padding=_pair(node.get("padding", (0, 0))),
            convolution_mode=str(node.get("convolutionMode",
                                          "Truncate")).lower(),
            pooling_type=str(node.get("poolingType", "MAX")).lower(),
            **{k: v for k, v in kw.items() if k in ("name", "updater")})
    if type_name == "batchNormalization":
        return L.BatchNorm(
            decay=float(node.get("decay", 0.9)),
            eps=float(node.get("eps", 1e-5)),
            lock_gamma_beta=bool(node.get("lockGammaBeta", False)),
            gamma_init=float(node.get("gamma", 1.0)),
            beta_init=float(node.get("beta", 0.0)), **kw)
    if type_name in ("gravesLSTM", "LSTM"):
        cls = L.GravesLSTM if type_name == "gravesLSTM" else L.LSTM
        ga = node.get("gateActivationFn")
        gate = (_activation_from({"activationFn": ga})
                if ga is not None else "sigmoid")
        return cls(n_in=n_in, n_out=n_out, gate_activation=gate or "sigmoid",
                   forget_gate_bias_init=float(
                       node.get("forgetGateBiasInit", 1.0)), **kw)
    if type_name == "activation":
        return L.Activation(**kw)
    if type_name == "dropout":
        return L.DropoutLayer(**kw)
    if type_name == "localResponseNormalization":
        return L.LRN(n=int(node.get("n", 5)), k=float(node.get("k", 2.0)),
                     alpha=float(node.get("alpha", 1e-4)),
                     beta=float(node.get("beta", 0.75)),
                     **{k: v for k, v in kw.items() if k == "name"})
    if type_name == "GlobalPooling":
        return L.GlobalPooling(pooling_type=str(
            node.get("poolingType", "MAX")).lower())
    raise ValueError(
        f"DL4J layer type {type_name!r} is not supported by the importer "
        f"(supported: dense/output/rnnoutput/loss/embedding/convolution/"
        f"subsampling/batchNormalization/LSTM/gravesLSTM/activation/"
        f"dropout/localResponseNormalization/GlobalPooling)")


_PREPROCESSORS = {
    "cnnToFeedForward": ("CnnToFeedForward", ("inputHeight", "inputWidth",
                                              "numChannels")),
    "feedForwardToCnn": ("FeedForwardToCnn", ("inputHeight", "inputWidth",
                                              "numChannels")),
    "cnnToRnn": ("CnnToRnn", ("inputHeight", "inputWidth", "numChannels")),
    "rnnToCnn": ("RnnToCnn", ("inputHeight", "inputWidth", "numChannels")),
    "feedForwardToRnn": ("FeedForwardToRnn", ()),
    "rnnToFeedForward": ("RnnToFeedForward", ()),
}


def _translate_preprocessor(node: dict):
    if "@class" in node:
        raw = node["@class"].rsplit(".", 1)[-1]
        key = raw[0].lower() + raw[1:]
        key = key[:-len("PreProcessor")] if key.endswith("PreProcessor") \
            else key
        body = node
    elif len(node) == 1:
        key = next(iter(node))
        body = node[key]
    else:
        raise ValueError(f"unrecognized preprocessor {node!r}")
    if key not in _PREPROCESSORS:
        raise ValueError(f"unsupported DL4J preprocessor {key!r}")
    cls_name, fields = _PREPROCESSORS[key]
    kwargs = {}
    if fields:
        h, w, c = (int(body.get(f, 0)) for f in fields)
        kwargs = {"height": h, "width": w, "channels": c}
    return getattr(pp, cls_name)(**kwargs)


def _layers_wrapper(wrapper):
    if not isinstance(wrapper, dict) or len(wrapper) != 1:
        raise ValueError(f"unrecognized layer wrapper {wrapper!r}")
    (type_name, node), = wrapper.items()
    return _translate_layer(type_name, node)


def _first_input_type(layer, n_in, what: str):
    """A feed-forward or recurrent input type from a first layer's nIn."""
    if n_in is None:
        raise ValueError(
            f"cannot infer the input type ({what} has no nIn, e.g. a "
            f"conv-first net); pass it explicitly "
            f"(it.convolutional(h, w, c))")
    return (it.recurrent(n_in, -1) if isinstance(layer, L.BaseRecurrent)
            else it.feed_forward(n_in))


def configuration_from_json(conf_json: str, input_type=None):
    """MultiLayerConfiguration JSON -> port MultiLayerConfiguration.

    `input_type` overrides shape inference; without it the input follows
    layer 0's nIn (feed-forward, or recurrent for a recurrent first layer).
    Conv-first nets need `it.convolutional(h, w, c)`: the reference JSON
    stores channel counts but not the spatial size."""
    d = json.loads(conf_json)
    confs = d.get("confs")
    if confs is None:
        raise ValueError(
            "configuration.json has no 'confs'; use "
            "restore_computation_graph for ComputationGraph zips")
    layers = [_layers_wrapper(c.get("layer")) for c in confs]
    conf = NeuralNetConfiguration(seed=int(d.get("seed", 12345))).list(layers)
    for idx, p in (d.get("inputPreProcessors") or {}).items():
        conf.input_preprocessor(int(idx), _translate_preprocessor(p))
    if d.get("backpropType", "Standard") == "TruncatedBPTT":
        conf.defaults.backprop_type = "tbptt"
        conf.defaults.tbptt_fwd_length = int(d.get("tbpttFwdLength", 20))
        conf.defaults.tbptt_back_length = int(d.get("tbpttBackLength", 20))
    if input_type is None:
        input_type = _first_input_type(layers[0],
                                       getattr(layers[0], "n_in", None),
                                       "layer 0")
    return conf.set_input_type(input_type)


# --------------------------------------------------------------------------
# flat coefficients -> per-layer arrays in the interchange layout
# --------------------------------------------------------------------------
def _take(flat, n, cursor):
    if cursor + n > flat.size:
        raise ValueError(f"coefficients.bin exhausted at {cursor + n} "
                         f"(have {flat.size})")
    return flat[cursor:cursor + n], cursor + n


def _lstm_permute_cols(block_4n: np.ndarray, n: int) -> np.ndarray:
    """The reference's (g, f, o, i) gate blocks (LSTMHelpers.java
    :216/:232/:256/:299) in the port cell's (i, f, g, o) order."""
    g, f, o, i = (block_4n[..., k * n:(k + 1) * n] for k in range(4))
    return np.concatenate([i, f, g, o], axis=-1)


def _interchange_shapes(layer, params) -> dict:
    """Each param's shape in the interchange layout."""
    return {k: tuple(layer.to_interchange(k, t).shape)
            for k, t in params.items()}


def _layer_params_from_flat(layer, shapes, n_stats, flat, cur,
                            include_bn_stats: bool = True):
    """Slice ONE layer's params (and BatchNorm's running mean/var) from the
    flat vector per its reference ParamInitializer layout, as numpy arrays
    in the interchange layout. `shapes` holds the layer's interchange
    shapes, `n_stats` BatchNorm's channel count. Returns (params,
    state_or_None, cursor).

    include_bn_stats=False is the UPDATER-STATE view of the same layout:
    BatchNorm's mean/var carry a NoOp updater (stateSize 0), so the state
    vector covers gamma/beta only."""
    p = {}
    new_state = None
    if isinstance(layer, L.LSTM):  # GravesLSTM too
        n_in = layer.n_in or int(shapes["W"][0])
        n = layer.n_out
        peep = isinstance(layer, L.GravesLSTM)
        r_cols = 4 * n + (PEEPHOLE_COLS if peep else 0)
        wbuf, cur = _take(flat, n_in * 4 * n, cur)
        rbuf, cur = _take(flat, n * r_cols, cur)
        bbuf, cur = _take(flat, 4 * n, cur)
        iw = np.reshape(wbuf, (n_in, 4 * n), order="F")
        rw = np.reshape(rbuf, (n, r_cols), order="F")
        p["W"] = _lstm_permute_cols(iw, n)
        p["R"] = _lstm_permute_cols(rw[:, :4 * n], n)
        p["b"] = _lstm_permute_cols(bbuf[None, :], n)[0]
        if peep:
            # rW columns 4n+0/+1/+2 feed the forget/output/input gates
            # (LSTMHelpers.java:109-115)
            p["pf"] = rw[:, 4 * n]
            p["po"] = rw[:, 4 * n + 1]
            p["pi"] = rw[:, 4 * n + 2]
    elif isinstance(layer, L.Conv2D):
        kh, kw, cin, n_out = shapes["W"]  # HWIO
        if layer.has_bias:
            p["b"], cur = _take(flat, n_out, cur)
        wbuf, cur = _take(flat, n_out * cin * kh * kw, cur)
        w = np.reshape(wbuf, (n_out, cin, kh, kw), order="C")
        p["W"] = np.transpose(w, (2, 3, 1, 0))
    elif isinstance(layer, L.BatchNorm):
        n = n_stats
        if not layer.lock_gamma_beta:
            p["gamma"], cur = _take(flat, n, cur)
            p["beta"], cur = _take(flat, n, cur)
        if include_bn_stats:
            mbuf, cur = _take(flat, n, cur)
            vbuf, cur = _take(flat, n, cur)
            new_state = {"mean": mbuf, "var": vbuf}
    elif "W" in shapes:  # Dense/Output/RnnOutput/Embedding family
        n_in, n_out = shapes["W"]
        wbuf, cur = _take(flat, n_in * n_out, cur)
        p["W"] = np.reshape(wbuf, (n_in, n_out), order="F")
        if "b" in shapes:
            p["b"], cur = _take(flat, n_out, cur)
    elif shapes:
        raise ValueError(f"layer {type(layer).__name__} has params but no "
                         f"known DL4J flat layout")
    missing = set(shapes) - set(p)
    if missing:
        raise ValueError(f"layer {type(layer).__name__}: the DL4J layout "
                         f"gives no {sorted(missing)}")
    for k, arr in p.items():
        if tuple(arr.shape) != tuple(shapes[k]):
            raise ValueError(
                f"layer {type(layer).__name__}: {k} from the flat vector has "
                f"shape {tuple(arr.shape)}, the network's is {shapes[k]}")
    return p, new_state, cur


def _bn_channels(state) -> int:
    return int(state["mean"].shape[0]) if state else 0


def _assign_layer(net, key, layer, flat, cur):
    """One layer's slice of `flat` into `net.params[key]` (and BatchNorm's
    running state), through the layer's interchange hooks onto the
    network's device. Returns the new cursor."""
    st0 = net.state.get(key)
    p, st, cur = _layer_params_from_flat(
        layer, _interchange_shapes(layer, net.params[key]),
        _bn_channels(st0), flat, cur)
    net.params[key] = interop.layer_params_from_jax(layer, p, net.device)
    if st is not None:
        net.state[key] = interop.layer_params_from_jax(None, st, net.device)
    return cur


def assign_params_from_flat(net, flat: np.ndarray) -> None:
    """Distribute a DL4J flat parameter vector over a port
    MultiLayerNetwork, layer by layer in layer order
    (MultiLayerNetwork.init():545-677)."""
    flat = np.asarray(flat, np.float32).ravel()
    cur = 0
    for i, layer in enumerate(net.layers):
        cur = _assign_layer(net, f"layer_{i}", layer, flat, cur)
    if cur != flat.size:
        raise ValueError(f"coefficients.bin has {flat.size} values but the "
                         f"network consumed {cur}")


def _read_entry(zf, names, *entries):
    """The first of `entries` present in the zip, as an nd4j array."""
    for e in entries:
        if e in names:
            return read_nd4j_array(io.BytesIO(zf.read(e)))
    return None


def _open_conf(zf, path) -> str:
    names = set(zf.namelist())
    if "configuration.json" not in names:
        raise ValueError(f"{path}: not a DL4J model zip "
                         f"(no configuration.json; entries {sorted(names)})")
    return zf.read("configuration.json").decode("utf-8")


def _load_updater(zf, net, it_count, ref_topo=None) -> None:
    """updaterState.bin (or the older updater.bin) into `net.opt_state`; an
    unreadable or mis-sized vector leaves fresh slots and warns
    (restoreMultiLayerNetwork(file, loadUpdater=false))."""
    names = set(zf.namelist())
    try:
        state_vec = _read_entry(zf, names, "updaterState.bin", "updater.bin")
        if state_vec is not None:
            import_updater_state(net, state_vec, iteration=it_count,
                                 ref_topo=ref_topo)
    except (ValueError, struct.error) as e:
        warnings.warn(
            f"updater state not imported ({e}); resumed training restarts "
            f"optimizer moments (equivalent to "
            f"restoreMultiLayerNetwork(file, loadUpdater=false))",
            stacklevel=3)


def restore_multi_layer_network(path: str, input_type=None,
                                load_updater: bool = False, device=None):
    """ModelSerializer.restoreMultiLayerNetwork(:148): configuration.json
    and coefficients.bin -> an initialized port MultiLayerNetwork on
    `device` (None: the card; "cpu" for the CPU) with the zip's weights,
    its `iterationCount` as `net.iteration` (so learning-rate schedules
    resume where they stopped) and, with `load_updater`, its updater
    state."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    with zipfile.ZipFile(path) as zf:
        conf_raw = _open_conf(zf, path)
        net = MultiLayerNetwork(
            configuration_from_json(conf_raw, input_type)).init(device)
        flat = _read_entry(zf, set(zf.namelist()), "coefficients.bin")
        if flat is not None:
            assign_params_from_flat(net, flat)
        meta = json.loads(conf_raw)
        net.iteration = max((int(c.get("iterationCount", 0))
                             for c in meta.get("confs", [])), default=0)
        if load_updater:
            _load_updater(zf, net, net.iteration)
    return net


# --------------------------------------------------------------------------
# ComputationGraph zips
# --------------------------------------------------------------------------
_VERTEX_TYPES = {
    # reference WRAPPER_OBJECT names (nn/conf/graph/GraphVertex.java:40-51)
    # -> (port class name, {json field -> ctor kwarg})
    "MergeVertex": ("MergeVertex", {}),
    "ElementWiseVertex": ("ElementWiseVertex", {"op": "op"}),
    "SubsetVertex": ("SubsetVertex", {"from": "from_idx", "to": "to_idx"}),
    "StackVertex": ("StackVertex", {}),
    "UnstackVertex": ("UnstackVertex", {"from": "from_idx",
                                        "stackSize": "stack_size"}),
    "L2Vertex": ("L2Vertex", {}),
    "L2NormalizeVertex": ("L2NormalizeVertex", {}),
    "ScaleVertex": ("ScaleVertex", {"scaleFactor": "scale_factor"}),
    "ShiftVertex": ("ShiftVertex", {"shiftFactor": "shift_factor"}),
    "LastTimeStepVertex": ("LastTimeStepVertex",
                           {"maskArrayInputName": "mask_input"}),
    "DuplicateToTimeSeriesVertex": ("DuplicateToTimeSeriesVertex", {}),
    "PoolHelperVertex": ("PoolHelperVertex", {}),
}


def _translate_vertex(type_name: str, body: dict):
    if type_name == "LayerVertex":
        layer = _layers_wrapper((body.get("layerConf") or {}).get("layer"))
        pre = body.get("preProcessor")
        return layer, (_translate_preprocessor(pre)
                       if isinstance(pre, dict) else None)
    if type_name == "PreprocessorVertex":
        return gv.PreprocessorVertex(
            preprocessor=_translate_preprocessor(body.get("preProcessor"))
        ), None
    if type_name not in _VERTEX_TYPES:
        raise ValueError(
            f"DL4J graph vertex {type_name!r} is not supported by the "
            f"importer (supported: {sorted(_VERTEX_TYPES)} + LayerVertex "
            f"+ PreprocessorVertex)")
    cls_name, fields = _VERTEX_TYPES[type_name]
    kwargs = {}
    for src, dst in fields.items():
        if src in body and body[src] is not None:
            v = body[src]
            kwargs[dst] = v.lower() if isinstance(v, str) and dst == "op" \
                else v
    return getattr(gv, cls_name)(**kwargs), None


def _reference_topological_order(network_inputs, vertex_inputs):
    """Kahn's algorithm exactly as the reference computes it
    (ComputationGraphConfiguration.topologicalOrdering():410-450): a FIFO
    queue seeded with networkInputs in order, children discovered in
    vertexInputs iteration (JSON insertion) order. The flat param order
    follows this sequence (ComputationGraph.init():393-455), so it must be
    reproduced exactly, not merely be *a* valid topological order."""
    outputs_to = {}
    for name, ins in vertex_inputs.items():
        for i in dict.fromkeys(ins):  # dedupe: [a, a] must enqueue once
            outputs_to.setdefault(i, []).append(name)
    remaining = {k: set(v) for k, v in vertex_inputs.items()}
    queue = list(network_inputs)
    order = []
    while queue:
        nxt = queue.pop(0)
        order.append(nxt)
        for child in outputs_to.get(nxt, []):
            remaining[child].discard(nxt)
            if not remaining[child]:
                queue.append(child)
    left = [k for k, v in remaining.items() if v]
    if left:
        raise ValueError(f"cycle in graph configuration at {left}")
    return [n for n in order if n not in set(network_inputs)]


def graph_configuration_from_json(conf_json: str, input_types=None):
    """ComputationGraphConfiguration JSON -> (port configuration, the
    reference's topological order). `input_types` (one per network input)
    overrides inference from the first consuming layer's nIn."""
    d = json.loads(conf_json)
    if "vertices" not in d:
        raise ValueError("configuration.json has no 'vertices'; use "
                         "restore_multi_layer_network for MLN zips")
    net_ins = list(d["networkInputs"])
    vertex_inputs = {k: list(v) for k, v in d["vertexInputs"].items()}
    g = NeuralNetConfiguration(
        seed=int((d.get("defaultConfiguration") or {}).get("seed", 12345))
    ).graph()
    g.add_inputs(*net_ins)
    translated = {}
    for name, wrapper in d["vertices"].items():
        if not isinstance(wrapper, dict) or len(wrapper) != 1:
            raise ValueError(f"unrecognized vertex wrapper {wrapper!r}")
        (vtype, body), = wrapper.items()
        obj, pre = _translate_vertex(vtype, body)
        ins = vertex_inputs[name]
        if pre is not None:
            # a reference LayerVertex carries an optional preprocessor; the
            # port puts it in a PreprocessorVertex before the layer
            pname = f"{name}__pre"
            while pname in d["vertices"]:
                pname += "_"
            g.add_vertex(pname, gv.PreprocessorVertex(preprocessor=pre),
                         *ins)
            ins = [pname]
        if isinstance(obj, gv.GraphVertex):
            g.add_vertex(name, obj, *ins)
        else:
            g.add_layer(name, obj, *ins)
        translated[name] = obj
    g.set_outputs(*d["networkOutputs"])
    if input_types is None:
        input_types = []
        for in_name in net_ins:
            consumer = next((translated[n] for n, ins in vertex_inputs.items()
                             if in_name in ins
                             and hasattr(translated.get(n), "n_in")), None)
            input_types.append(_first_input_type(
                consumer, getattr(consumer, "n_in", None),
                f"the first layer reading {in_name!r}"))
    g.set_input_types(*input_types)
    return g, _reference_topological_order(net_ins, vertex_inputs)


def _graph_units(net, ref_topo):
    """(name, layer) of each layer vertex, in the reference's order. The
    order is built from the raw JSON, so the port's '{name}__pre'
    preprocessor vertices never appear in it."""
    return [(n, net.conf.vertices[n].layer) for n in ref_topo
            if isinstance(net.conf.vertices.get(n), gv.LayerVertex)]


def assign_graph_params_from_flat(net, flat, ref_topo) -> None:
    """Distribute the flat vector over a port ComputationGraph in the
    REFERENCE's topological order (ComputationGraph.init():455)."""
    flat = np.asarray(flat, np.float32).ravel()
    cur = 0
    for name, layer in _graph_units(net, ref_topo):
        if net.params.get(name):
            cur = _assign_layer(net, name, layer, flat, cur)
    if cur != flat.size:
        raise ValueError(f"coefficients.bin has {flat.size} values but "
                         f"the graph consumed {cur}")


def restore_computation_graph(path: str, input_types=None,
                              load_updater: bool = False, device=None):
    """ModelSerializer.restoreComputationGraph: the DAG form of
    restore_multi_layer_network, on `device` (None: the card)."""
    from deeplearning4j_tpu_torch.models import ComputationGraph

    with zipfile.ZipFile(path) as zf:
        conf_raw = _open_conf(zf, path)
        g, ref_topo = graph_configuration_from_json(conf_raw, input_types)
        net = ComputationGraph(g.build()).init(device)
        flat = _read_entry(zf, set(zf.namelist()), "coefficients.bin")
        if flat is not None:
            assign_graph_params_from_flat(net, flat, ref_topo)
        meta = json.loads(conf_raw)
        net.iteration = int(meta.get(
            "iterationCount", (meta.get("defaultConfiguration") or {})
            .get("iterationCount", 0)))
        if load_updater:
            _load_updater(zf, net, net.iteration, ref_topo)
    return net


# --------------------------------------------------------------------------
# updaterState.bin
# --------------------------------------------------------------------------
# per-updater slot layout inside one UpdaterBlock's contiguous state view
# (nd4j GradientUpdater.setStateViewArray conventions) -> the port's slots
_UPDATER_SLOTS = {
    "nesterovs": ["v"],       # NesterovsUpdater: momentum buffer
    "adam": ["m", "v"],       # AdamUpdater: first then second moment
    "adagrad": ["h"],         # AdaGradUpdater: historical gradient
    "rmsprop": ["g2"],        # RmsPropUpdater: lastGradient accumulator
    "adadelta": ["msg", "msdx"],
    "sgd": [],
}


def _n_params(params) -> int:
    return int(sum(t.numel() for _, t in flat_items(params)))


def import_updater_state(net, flat_state: np.ndarray,
                         iteration: int = 0, ref_topo=None) -> None:
    """Distribute a DL4J updaterState.bin vector over a port network's
    `opt_state` (restore*(file, loadUpdater=true), ModelSerializer.java
    :148). A MultiLayerNetwork walks its layers in order; a
    ComputationGraph needs `ref_topo`, the reference's Kahn order, which
    fixes the state walk as it fixes the param walk.

    Only a uniform configuration imports (every layer with params resolves
    to the same updater, the common case); heterogeneous per-layer
    updaters raise, so the caller keeps fresh slots rather than
    mis-slicing. Each slot's segment is sliced with the params' own layout
    transforms (gate permutation, conv transpose) and goes in through the
    layer's interchange hooks; an Adam step count takes `iteration` (DL4J
    stores none)."""
    if isinstance(net.opt_state, dict):  # ComputationGraph
        if ref_topo is None:
            raise ValueError(
                "ComputationGraph updater import needs the reference "
                "topological order (ref_topo)")
        units = _graph_units(net, ref_topo)
        updaters = [net._updaters[n] for n, _ in units]
        opt_of = {n: net.opt_state[n] for n, _ in units}
    else:
        units = [(f"layer_{i}", layer) for i, layer in enumerate(net.layers)]
        updaters = list(net._updaters)
        opt_of = dict(zip((k for k, _ in units), net.opt_state))

    # uniformity over units WITH params: paramless layers (dropout, pooling,
    # activation, LRN) carry no updater in the DL4J JSON, hold no state and
    # never split a block, so they must not veto the import
    checked = [u for (key, _), u in zip(units, updaters) if net.params[key]]
    if not checked:
        return
    u0 = checked[0]
    if any(u != u0 for u in checked[1:]):
        raise ValueError(
            "updater state import supports uniform per-layer updater "
            "configuration only (UpdaterBlock coalescing would split "
            "differently); restoring with fresh optimizer moments")
    slots = _UPDATER_SLOTS.get(getattr(u0, "name", None))
    if slots is None:
        raise ValueError(f"updater state import not supported for "
                         f"{type(u0).__name__}")
    flat_state = np.asarray(flat_state, np.float32).ravel()
    if not slots:
        return  # Sgd: stateless

    # blocks of unit keys: EVERY BatchNorm ends a block, its NoOp mean/var
    # splitting the run even when lock_gamma_beta leaves it no params
    blocks, current = [], []
    for key, layer in units:
        if net.params[key]:
            current.append((key, layer))
        if isinstance(layer, L.BatchNorm):
            if current:
                blocks.append(current)
            current = []
    if current:
        blocks.append(current)

    cur = 0
    new_opt = {}
    for block in blocks:
        seg = {}
        for slot in slots:
            seg[slot], cur = _take(
                flat_state, sum(_n_params(net.params[k]) for k, _ in block),
                cur)
        off = 0
        for key, layer in block:
            n_i = _n_params(net.params[key])
            shapes = _interchange_shapes(layer, net.params[key])
            n_stats = _bn_channels(net.state.get(key))
            entry = {}
            for slot in slots:
                tree, _, end = _layer_params_from_flat(
                    layer, shapes, n_stats, seg[slot], off,
                    include_bn_stats=False)
                if end != off + n_i:
                    raise ValueError(
                        f"updater slice mismatch for {key}: consumed "
                        f"{end - off}, expected {n_i}")
                entry[slot] = interop.layer_params_from_jax(layer, tree,
                                                            net.device)
            if isinstance(opt_of[key], dict) and "t" in opt_of[key]:
                # DL4J keeps no step count in the view; the conf's
                # iterationCount is the bias-correction clock
                entry["t"] = torch.tensor(iteration, dtype=torch.int32,
                                          device=net.device)
            new_opt[key] = entry
            off += n_i
    if cur != flat_state.size:
        raise ValueError(
            f"updaterState.bin has {flat_state.size} values but the "
            f"updater layout consumed {cur}")
    if isinstance(net.opt_state, dict):
        net.opt_state = {**net.opt_state, **new_opt}
    else:
        net.opt_state = [new_opt.get(k, opt_of[k]) for k, _ in units]


# --------------------------------------------------------------------------
# normalizer.bin: nd4j NormalizerSerializer container
# --------------------------------------------------------------------------
# Layout (nd4j NormalizerSerializer.write and its strategies; the zip entry
# is written by ModelSerializer.addNormalizerToModel, util/ModelSerializer
# .java:585, and read back at :600-611):
#   writeUTF(NormalizerType.toString())       -- the header
#   then the strategy payload:
#     STANDARDIZE: writeBoolean(fitLabel); Nd4j.write(mean); Nd4j.write(std)
#                  [; labelMean; labelStd]
#     MIN_MAX:     writeBoolean(fitLabel); writeDouble(targetMin);
#                  writeDouble(targetMax); Nd4j.write(min); Nd4j.write(max)
#                  [; labelMin; labelMax]
#     IMAGE_MIN_MAX: writeDouble(minRange); writeDouble(maxRange);
#                  writeDouble(maxPixelVal)
# MULTI_* (per-column MultiDataSet normalizers) and CUSTOM strategies
# refuse.

NORMALIZER_BIN = "normalizer.bin"


def _stat(f) -> torch.Tensor:
    return torch.from_numpy(read_nd4j_array(f).ravel().astype(np.float32))


def read_normalizer(f):
    """One NormalizerSerializer stream -> a port Normalizer (statistics as
    float32 tensors on the CPU)."""
    from deeplearning4j_tpu_torch.datasets import normalizers as nm

    ntype = _read_utf(f)
    if ntype == "STANDARDIZE":
        (fit_label,) = struct.unpack(">?", f.read(1))
        n = nm.NormalizerStandardize(fit_labels=bool(fit_label))
        n.mean, n.std = _stat(f), _stat(f)
        if fit_label:
            n.label_mean, n.label_std = _stat(f), _stat(f)
        return n
    if ntype == "MIN_MAX":
        (fit_label,) = struct.unpack(">?", f.read(1))
        lo, hi = struct.unpack(">dd", f.read(16))
        n = nm.NormalizerMinMaxScaler(min_range=lo, max_range=hi)
        n.data_min, n.data_max = _stat(f), _stat(f)
        if fit_label:
            n.fit_labels = True
            n.label_min, n.label_max = _stat(f), _stat(f)
        return n
    if ntype == "IMAGE_MIN_MAX":
        lo, hi, px = struct.unpack(">ddd", f.read(24))
        return nm.ImagePreProcessingScaler(min_range=lo, max_range=hi,
                                           max_pixel=px)
    raise ValueError(
        f"normalizer.bin strategy {ntype!r} is not importable (supported: "
        f"STANDARDIZE, MIN_MAX, IMAGE_MIN_MAX; MULTI_*/CUSTOM need the "
        f"MultiDataSet normalizers)")


def _row(t) -> np.ndarray:
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                      np.float32).reshape(1, -1)


def write_normalizer(f, norm) -> None:
    """Inverse of read_normalizer, in the reference layout."""
    from deeplearning4j_tpu_torch.datasets import normalizers as nm

    if isinstance(norm, nm.NormalizerStandardize):
        _write_utf(f, "STANDARDIZE")
        f.write(struct.pack(">?", bool(norm.fit_labels)))
        stats = [norm.mean, norm.std]
        if norm.fit_labels:
            stats += [norm.label_mean, norm.label_std]
    elif isinstance(norm, nm.NormalizerMinMaxScaler):
        _write_utf(f, "MIN_MAX")
        f.write(struct.pack(">?", bool(norm.fit_labels)))
        f.write(struct.pack(">dd", norm.min_range, norm.max_range))
        stats = [norm.data_min, norm.data_max]
        if norm.fit_labels:
            stats += [norm.label_min, norm.label_max]
    elif isinstance(norm, nm.ImagePreProcessingScaler):
        _write_utf(f, "IMAGE_MIN_MAX")
        f.write(struct.pack(">ddd", norm.min_range, norm.max_range,
                            norm.max_pixel))
        stats = []
    else:
        raise ValueError(f"cannot encode normalizer {type(norm).__name__}")
    for s in stats:
        write_nd4j_array(f, _row(s))


def restore_normalizer(path: str):
    """ModelSerializer.restoreNormalizerFromFile (:598-611) for any model
    zip: `models.serialization.restore_normalizer`, which reads the
    framework's `normalizer.json` (preferred when both are present) and the
    reference's `normalizer.bin`, under the modelimport name."""
    from deeplearning4j_tpu_torch.models.serialization import (
        restore_normalizer as _restore,
    )

    return _restore(path)
