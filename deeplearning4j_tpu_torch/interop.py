"""Carries weights from the JAX package into a port network.

`params_from_jax(net, params, state)` takes a JAX ComputationGraph's
`params` and `state` as nested dicts of numpy arrays (vertex name ->
{"W", "b", "gamma", "beta"} / {"mean", "var"}) and loads them into a port
network built from the same config, under the same names. Each layer
converts from the interchange layout to its own once (Conv2D: HWIO ->
OIHW channels_last). Afterwards both packages compute the same function.

Names, shapes and the set of entries must match exactly; anything else
raises, so a half-loaded network cannot run.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from deeplearning4j_tpu_torch.models import ComputationGraph

Arrays = Mapping[str, Mapping[str, np.ndarray]]


def layer_params_from_jax(layer, params: Mapping[str, np.ndarray],
                          device=None) -> Dict[str, torch.Tensor]:
    """One layer's params from the interchange layout into the port's
    layout, float32 on `device` (None: the CPU)."""
    out = {}
    for key, arr in params.items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        t = t if layer is None else layer.from_interchange(key, t)
        out[key] = t.to("cpu" if device is None else device)
    return out


def _load(kind: str, current: Dict[str, Dict[str, torch.Tensor]],
          incoming: Arrays, net: ComputationGraph):
    if set(incoming) != set(current):
        raise ValueError(
            f"{kind} vertices differ: missing "
            f"{sorted(set(current) - set(incoming))}, unexpected "
            f"{sorted(set(incoming) - set(current))}")
    loaded = {}
    for name, have in current.items():
        got = incoming[name]
        if set(got) != set(have):
            raise ValueError(f"{kind} of vertex '{name}': expected keys "
                             f"{sorted(have)}, got {sorted(got)}")
        layer = net.layer(name) if kind == "params" else None
        new = layer_params_from_jax(layer, got, net.device)
        for key, t in new.items():
            if t.shape != have[key].shape:
                raise ValueError(
                    f"{kind} {name}/{key}: shape {tuple(t.shape)} does not "
                    f"match the port network's {tuple(have[key].shape)}")
        loaded[name] = new
    return loaded


def params_from_jax(net: ComputationGraph, params: Arrays,
                    state: Arrays) -> ComputationGraph:
    """Replace `net`'s params and running state with the JAX network's
    (see module docstring). `net` must be initialized; returns it."""
    if net.params is None:
        raise RuntimeError("init() the port network before loading weights")
    new_params = _load("params", net.params, params, net)
    new_state = _load("state", net.state, state, net)
    net.params, net.state = new_params, new_state
    return net
