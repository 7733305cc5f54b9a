"""Carries weights from the JAX package into a port network.

`params_from_jax(net, params, state)` takes a JAX network's `params` and
`state` as nested dicts of numpy arrays and loads them into a port network
built from the same config, under the same names:

  - ComputationGraph: vertex name -> {"W", "b", "gamma", "beta"} /
    {"mean", "var"};
  - MultiLayerNetwork: "layer_{i}" -> that layer's dict, nested where the
    layer nests sublayers (TransformerBlock: "ln1", "attn" with "Wqkv",
    "bqkv", "Wo", "bo", "ln2", "W1", "b1", "W2", "b2").

Each layer converts from the interchange layout to its own once (Conv2D:
HWIO -> OIHW channels_last), by the param's '/'-joined path. Afterwards
both packages compute the same function.

Names, shapes and the set of entries must match exactly at every level of
nesting; anything else raises, so a half-loaded network cannot run.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.multi_layer_network import flat_items

Arrays = Mapping[str, Mapping[str, object]]


def layer_params_from_jax(layer, params: Mapping[str, object], device=None,
                          prefix: str = "") -> Dict[str, object]:
    """One layer's params (a nested dict of arrays) from the interchange
    layout into the port's layout, float32 on `device` (None: the CPU)."""
    out = {}
    for key, arr in params.items():
        path = f"{prefix}{key}"
        if isinstance(arr, Mapping):
            out[key] = layer_params_from_jax(layer, arr, device, path + "/")
            continue
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        t = t if layer is None else layer.from_interchange(path, t)
        out[key] = t.to("cpu" if device is None else device)
    return out


def _shapes(tree) -> Dict[str, tuple]:
    return {path: tuple(t.shape) for path, t in flat_items(tree)}


def _load(kind: str, current, incoming: Arrays, net):
    if set(incoming) != set(current):
        raise ValueError(
            f"{kind} entries differ: missing "
            f"{sorted(set(current) - set(incoming))}, unexpected "
            f"{sorted(set(incoming) - set(current))}")
    loaded = {}
    for name, have in current.items():
        layer = net.layer(name) if kind == "params" else None
        new = layer_params_from_jax(layer, incoming[name], net.device)
        want, got = _shapes(have), _shapes(new)
        if set(got) != set(want):
            raise ValueError(f"{kind} of '{name}': expected keys "
                             f"{sorted(want)}, got {sorted(got)}")
        for path, shape in got.items():
            if shape != want[path]:
                raise ValueError(
                    f"{kind} {name}/{path}: shape {shape} does not match "
                    f"the port network's {want[path]}")
        loaded[name] = new
    return loaded


def params_from_jax(net, params: Arrays, state: Arrays):
    """Replace `net`'s params and running state with the JAX network's
    (see module docstring). `net` (a ComputationGraph or MultiLayerNetwork)
    must be initialized; returns it."""
    if net.params is None:
        raise RuntimeError("init() the port network before loading weights")
    new_params = _load("params", net.params, params, net)
    new_state = _load("state", net.state, state, net)
    net.params, net.state = new_params, new_state
    return net
