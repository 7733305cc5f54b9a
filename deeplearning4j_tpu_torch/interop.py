"""Carries weights from the JAX package into a port network.

`params_from_jax(net, params, state)` takes a JAX network's `params` and
`state` as nested dicts of numpy arrays and loads them into a port network
built from the same config, under the same names:

  - ComputationGraph: vertex name -> {"W", "b", "gamma", "beta"} /
    {"mean", "var"};
  - MultiLayerNetwork: "layer_{i}" -> that layer's dict, nested where the
    layer nests sublayers (TransformerBlock: "ln1", "attn" with "Wqkv",
    "bqkv", "Wo", "bo", "ln2", "W1", "b1", "W2", "b2").

Each layer converts from the interchange layout to its own once (Conv2D's
and Conv1D's W, SeparableConv2D's dW and pW: HWIO -> OIHW channels_last;
Deconv2D keeps its HWIO W), by the param's '/'-joined path. Running state
(BatchNorm's "mean" and "var", CenterLossOutput's "centers") is carried as
it is. Afterwards both packages compute the same function.

`params_to_jax(net)` is the reverse, numpy arrays in the interchange
layout.

`opt_state_from_jax(net, opt_state)` carries a JAX network's updater slots
across, so a run started in the JAX package resumes in the port: a
MultiLayerNetwork's list with one entry per layer, a ComputationGraph's
dict with one entry per vertex name, each under the JAX names (Adam's "m"
and "v" nested like the layer's params, its step count "t"; Nesterovs'
"v"). Slots that mirror params convert like params (a Conv2D kernel's HWIO
to the port's OIHW channels_last). `opt_state_to_jax(net)` is the reverse,
as numpy arrays in the interchange layout, in the network's own container.

Names, shapes and the set of entries must match exactly at every level of
nesting; anything else raises, so a half-loaded network cannot run.

`sharded_lm_params_from_jax(lm, params, opt_state=None)` carries a JAX
`parallel.transformer.ShardedTransformerLM`'s params ("embed", "pos", the
stacked "blocks", "lnf", in its layout) and, where given, its updater
state (Adam's "m" and "v" nested like the params, its step count "t")
into the port's ShardedTransformerLM of the same config: every rank keeps
its slices of the port's grid.

Both directions take whole params and slots. On a network that
ParallelWrapper shards (fsdp or model axis) they are collective: the
`_to_jax` side gathers, the `_from_jax` side checks against the whole
shapes and keeps this rank's slices.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from deeplearning4j_tpu_torch.models._training import (
    flat_items,
    whole_params,
    whole_slots,
)

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
        # C order: a Fortran-ordered array (DL4J's flat views) would give a
        # tensor with column-major strides
        t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
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
    arr = net._shard_layout
    new_params = _load("params", {k: whole_params(net, k)
                                  for k in net.params}, params, net)
    new_state = _load("state", net.state, state, net)
    net.params, net.state = new_params, new_state
    if arr is not None:
        arr.place(net, slots=False)
    return net


def _layer_slots_from_jax(layer, have, incoming, device, where: str):
    """One layer's updater state: dict slots that mirror the params convert
    like params (float32, the layer's layout), scalar slots keep their
    dtype; () stays ()."""
    if isinstance(have, tuple):
        if tuple(incoming) != ():
            raise ValueError(f"{where}: the port's updater keeps no slots, "
                             f"got {type(incoming).__name__}")
        return ()
    if not isinstance(incoming, Mapping) or set(incoming) != set(have):
        got = sorted(incoming) if isinstance(incoming, Mapping) else incoming
        raise ValueError(f"{where}: expected slots {sorted(have)}, got "
                         f"{got}")
    out = {}
    for slot, cur in have.items():
        if isinstance(cur, dict):
            new = layer_params_from_jax(layer, incoming[slot], device)
            want, got = _shapes(cur), _shapes(new)
            if want != got:
                raise ValueError(f"{where}/{slot}: shapes {got} do not "
                                 f"match the port network's {want}")
        else:
            arr = np.asarray(incoming[slot])
            if arr.shape != tuple(cur.shape):
                raise ValueError(f"{where}/{slot}: shape {arr.shape}, the "
                                 f"port network's {tuple(cur.shape)}")
            new = torch.from_numpy(np.array(arr)).to(cur.dtype).to(
                cur.device)
        out[slot] = new
    return out


def _entries(net):
    """(key, layer or None) of each updater-state entry: vertex names of a
    ComputationGraph, layer indices of a MultiLayerNetwork."""
    if isinstance(net.opt_state, dict):
        return [(name, net.layer(name)) for name in net.opt_state]
    return list(enumerate(net.layers))


def opt_state_from_jax(net, opt_state):
    """Replace an initialized network's updater slots with a JAX network's
    `opt_state` (numpy or JAX arrays): a list with one entry per layer for
    a MultiLayerNetwork, a dict keyed by vertex name for a
    ComputationGraph. Returns `net`."""
    if net.opt_state is None:
        raise RuntimeError("init() the port network before loading slots")
    if isinstance(net.opt_state, dict):
        if not isinstance(opt_state, Mapping) or \
                set(opt_state) != set(net.opt_state):
            got = sorted(opt_state) if isinstance(opt_state, Mapping) \
                else type(opt_state).__name__
            raise ValueError(f"opt_state entries differ: expected vertices "
                             f"{sorted(net.opt_state)}, got {got}")
    elif len(opt_state) != len(net.opt_state):
        raise ValueError(f"opt_state has {len(opt_state)} layers, the port "
                         f"network {len(net.opt_state)}")
    new = {key: _layer_slots_from_jax(
        layer, _whole_entry(net, key), opt_state[key], net.device,
        f"opt_state[{key!r}]") for key, layer in _entries(net)}
    net.opt_state = (new if isinstance(net.opt_state, dict)
                     else [new[i] for i in range(len(new))])
    if net._shard_layout is not None:
        net._shard_layout.place(net, params=False)
    return net


def _whole_entry(net, key):
    st = net.opt_state[key]
    return st if isinstance(st, tuple) else whole_slots(
        net, _param_key(net, key), st)


def _to_interchange(layer, tree, prefix: str = ""):
    out = {}
    for key, t in tree.items():
        path = f"{prefix}{key}"
        if isinstance(t, dict):
            out[key] = _to_interchange(layer, t, path + "/")
        else:
            if layer is not None:
                t = layer.to_interchange(path, t)
            out[key] = t.detach().cpu().numpy()
    return out


def params_to_jax(net):
    """(params, state) of the port network as the JAX package keeps them:
    nested dicts of numpy arrays in the interchange layout, under the
    network's own keys (the inverse of `params_from_jax`)."""
    params = {name: _to_interchange(net.layer(name),
                                    whole_params(net, name))
              for name in net.params}
    return params, {name: _to_interchange(None, s)
                    for name, s in net.state.items()}


def _param_key(net, key):
    """The params key of an updater-state entry (a list index for a
    MultiLayerNetwork)."""
    return f"layer_{key}" if isinstance(key, int) else key


def opt_state_to_jax(net):
    """The port network's updater slots as the JAX package keeps them: one
    entry per layer (a list) or per vertex (a dict), dict slots as nested
    numpy arrays in the interchange layout, scalar slots as numpy scalars
    of their dtype, () as ()."""
    out = {}
    for key, layer in _entries(net):
        st = _whole_entry(net, key)
        if isinstance(st, tuple):
            out[key] = ()
            continue
        out[key] = {slot: (_to_interchange(layer, v) if isinstance(v, dict)
                           else v.detach().cpu().numpy())
                    for slot, v in st.items()}
    return out if isinstance(net.opt_state, dict) else list(out.values())


def sharded_lm_params_from_jax(lm, params: Arrays, opt_state=None) -> None:
    """A JAX ShardedTransformerLM's whole params (and updater state), nested
    dicts of arrays, into the port's `lm` (names and shapes checked; each
    rank keeps its slices)."""
    lm.load_params(params, opt_state)
