"""The framework's own checkpoint zip (counterpart of
deeplearning4j_tpu/models/serialization.py; ModelSerializer.writeModel /
restoreMultiLayerNetwork, util/ModelSerializer.java:39-148). The container
is the JAX package's, member for member, so either package restores the
other's zips:

    configuration.json   the MultiLayerConfiguration or
                         ComputationGraphConfiguration JSON (the same JSON
                         in both packages)
    coefficients.npz     params, {"layer_0/W": array, ...}
    state.npz            running state (BatchNorm's mean and var)
    updaterState.npz     the updater slots ({"0/m/W": ..., "0/t": ...} for
                         a MultiLayerNetwork, {"vertex/v/W": ...} for a
                         ComputationGraph)
    normalizer.json      optional data normalizer
    metadata.json        format and framework version, model type,
                         iteration, epoch

An npz key is the JAX pytree path of the array, its parts joined by "/":
dict keys, list indices; the port writes the same keys from its own nested
dicts and lists, keys in sorted order as JAX flattens them. Arrays are
written in the interchange layout and dtypes (float32 params, int32 step
counts, Conv2D kernels HWIO), so nothing in a zip shows which package wrote
it. Writing copies every tensor to the host; restoring builds the network
from its configuration on `device` (None: the card) and loads every array
through its layer's interchange hook (`interop`), checking names and
shapes.

A configuration that names a layer or vertex class the port has not
ported yet raises NotImplementedError naming the class and
the ROADMAP item that brings it.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch import __version__, interop

FORMAT_VERSION = 1

# classes of the JAX package a checkpoint may name that the port has not
# ported yet -> the ROADMAP item that brings them
_NOT_PORTED = dict.fromkeys(
    ("AutoEncoder", "RBM", "VariationalAutoencoder", "CenterLossOutput",
     "Conv1D", "Deconv2D", "SeparableConv2D", "Subsampling1D",
     "Upsampling1D", "Upsampling2D", "ZeroPadding1D", "ZeroPadding2D",
     "ElementWiseMultiplication", "Yolo2Output"), "A.8")


def _key_parts(tree, prefix=""):
    """(key, leaf) of a nested dict/list/tuple of tensors or arrays, keys
    as JAX's tree_flatten_with_path paths joined by '/' (dict keys sorted,
    list and tuple indices in order); empty containers and None give no
    leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _key_parts(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _key_parts(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _npz_bytes(tree) -> bytes:
    arrays = {key: np.asarray(leaf) for key, leaf in _key_parts(tree)}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _gather(tree, data: Dict[str, np.ndarray], prefix: str = ""):
    """`tree`'s structure with the arrays of `data` under the same keys;
    raises KeyError naming the first one missing."""
    if isinstance(tree, dict):
        return {k: _gather(v, data, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_gather(v, data, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    key = prefix[:-1]
    if key not in data:
        raise KeyError(f"checkpoint missing array '{key}'")
    return data[key]


def write_model(net, path, save_updater: bool = True, normalizer=None):
    """Serialize a MultiLayerNetwork or ComputationGraph to a zip at
    `path` (ModelSerializer.writeModel)."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph,
    )

    is_graph = isinstance(net, ComputationGraph)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", net.conf.to_json())
        params, state = interop.params_to_jax(net)
        z.writestr("coefficients.npz", _npz_bytes(params))
        z.writestr("state.npz", _npz_bytes(state))
        if save_updater and net.opt_state is not None:
            z.writestr("updaterState.npz",
                       _npz_bytes(interop.opt_state_to_jax(net)))
        if normalizer is not None:
            z.writestr("normalizer.json", json.dumps(normalizer.to_json()))
        z.writestr("metadata.json", json.dumps({
            "format_version": FORMAT_VERSION,
            "framework_version": __version__,
            "model_type": ("ComputationGraph" if is_graph
                           else "MultiLayerNetwork"),
            "iteration": int(net.iteration),
            "epoch": int(net.epoch),
        }))


def _load_npz(z: zipfile.ZipFile, name: str
              ) -> Optional[Dict[str, np.ndarray]]:
    if name not in z.namelist():
        return None
    data = np.load(io.BytesIO(z.read(name)))
    return {k: data[k] for k in data.files}


def restore_normalizer(path):
    """The normalizer archived with the model, or None
    (ModelSerializer.restoreNormalizerFromFile). Reads this framework's
    `normalizer.json` and, failing that, DL4J's binary `normalizer.bin`
    (modelimport/dl4j.py decodes it), so one call serves checkpoints and
    DL4J zips alike."""
    from deeplearning4j_tpu_torch.datasets.normalizers import Normalizer

    with zipfile.ZipFile(path, "r") as z:
        names = set(z.namelist())
        if "normalizer.json" in names:
            return Normalizer.from_json(json.loads(z.read("normalizer.json")))
        if "normalizer.bin" in names:
            from deeplearning4j_tpu_torch.modelimport.dl4j import (
                read_normalizer,
            )

            return read_normalizer(io.BytesIO(z.read("normalizer.bin")))
        return None


def _refuse_not_ported(node, where: str = "configuration") -> None:
    """Raise NotImplementedError at the first class in a checkpoint's
    configuration that the port has not ported yet."""
    if isinstance(node, dict):
        t = node.get("type")
        if isinstance(t, str) and t in _NOT_PORTED:
            raise NotImplementedError(
                f"{where} names {t}, which the port has not ported yet "
                f"(ROADMAP A, item {_NOT_PORTED[t]})")
        for k, v in node.items():
            _refuse_not_ported(v, f"{where}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _refuse_not_ported(v, f"{where}/{i}")


def _restore(path, conf_cls, net_cls, load_updater: bool, device):
    with zipfile.ZipFile(path, "r") as z:
        raw = z.read("configuration.json").decode()
        _refuse_not_ported(json.loads(raw))
        net = net_cls(conf_cls.from_json(raw)).init(device)
        meta = json.loads(z.read("metadata.json").decode())
        coeff = _load_npz(z, "coefficients.npz")
        state = _load_npz(z, "state.npz") or {}
        interop.params_from_jax(
            net, {k: _gather(p, coeff, f"{k}/") for k, p in net.params.items()},
            {k: _gather(s, state, f"{k}/") for k, s in net.state.items()})
        if load_updater:
            upd = _load_npz(z, "updaterState.npz")
            if upd is not None:
                interop.opt_state_from_jax(net, _gather(net.opt_state, upd))
        net.iteration = meta.get("iteration", 0)
        net.epoch = meta.get("epoch", 0)
    return net


def restore_multi_layer_network(path, load_updater: bool = True,
                                device=None):
    """A MultiLayerNetwork zip onto `device` (None: the card)."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork,
    )
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    return _restore(path, MultiLayerConfiguration, MultiLayerNetwork,
                    load_updater, device)


def restore_computation_graph(path, load_updater: bool = True, device=None):
    """A ComputationGraph zip onto `device` (None: the card)."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph,
    )
    from deeplearning4j_tpu_torch.nn.graph_conf import (
        ComputationGraphConfiguration,
    )

    return _restore(path, ComputationGraphConfiguration, ComputationGraph,
                    load_updater, device)


def restore_model(path, load_updater: bool = True, device=None):
    """Dispatch on metadata's model_type (the ModelSerializer.restore*
    family)."""
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("metadata.json").decode())
    restore = (restore_computation_graph
               if meta.get("model_type") == "ComputationGraph"
               else restore_multi_layer_network)
    return restore(path, load_updater, device)
