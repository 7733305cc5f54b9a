"""MultiLayerNetwork — sequential-network runtime, inference part (counterpart
of deeplearning4j_tpu/models/multi_layer_network.py; fit, losses, tBPTT
and evaluation come with later slices).

A forward walks the layers eagerly under `torch.inference_mode()`: each
layer's input preprocessor, its `apply` (or, with carries, a recurrent
layer's `scan`), then `propagate_mask` for the next layer. Params and
running state are dicts per layer keyed "layer_{i}", with the JAX package's
names (nested where a layer nests sublayers, as TransformerBlock does), on
the device `init` was given. `rnn_time_step` streams: each recurrent
layer's (h, c) carry is kept between calls (rnnTimeStep).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch.models.computation_graph import _as_tensor
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrent

Params = Dict[str, object]


def _key(i: int) -> str:
    return f"layer_{i}"


def _to(tree, device):
    """A (nested) dict of tensors moved to `device`."""
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def flat_items(tree, prefix: str = ""):
    """(path, tensor) pairs of a nested param dict, paths joined by '/'
    ("attn/Wqkv"), in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from flat_items(v, path + "/")
        else:
            yield path, v


class MultiLayerNetwork:
    """Construction computes the per-layer input types; `init` allocates
    params (MultiLayerNetwork.init)."""

    def __init__(self, conf: MultiLayerConfiguration):
        conf.validate()
        self.conf = conf
        self.layers: List[Layer] = conf.layers
        self.params: Optional[Dict[str, Params]] = None
        self.state: Optional[Dict[str, Params]] = None
        self.device: Optional[torch.device] = None
        self._input_types = conf.layer_input_types()
        self._rnn_carries: Optional[list] = None

    def init(self, device=None) -> "MultiLayerNetwork":
        """Random params from `conf.defaults.seed` (one CPU torch.Generator
        drawn layer by layer, so a seed gives the same weights on every
        device), running state at its defaults, all on `device` (default:
        the CUDA card; pass device="cpu" for the CPU)."""
        self.device = device_mod.resolve(device)
        gen = torch.Generator().manual_seed(int(self.conf.defaults.seed))
        self.params, self.state = {}, {}
        for i, layer in enumerate(self.layers):
            in_type = self._input_types[i]
            p = layer.init_params(gen, in_type) if layer.has_params() else {}
            self.params[_key(i)] = _to(p, self.device)
            self.state[_key(i)] = _to(layer.init_state(in_type), self.device)
        return self

    def layer(self, key: str) -> Layer:
        """The Layer config under a param key ("layer_3")."""
        return self.layers[int(key.rsplit("_", 1)[1])]

    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params.values()
                       for _, t in flat_items(p)))

    def _as_input(self, x) -> torch.Tensor:
        """x on the network's device in its own dtype: token ids stay
        integers for the embedding's index."""
        if self.params is None:
            raise RuntimeError("call init() before running the network")
        return _as_tensor(x).to(self.device)

    def _forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 acts: Optional[list] = None,
                 carries: Optional[list] = None) -> torch.Tensor:
        """Inference forward through every layer; appends each layer's
        activation to `acts` when given. With `carries` (one entry per
        layer, see `_init_carries`) a recurrent layer scans from its entry
        and the entry is replaced by its new carry, in place."""
        for i, layer in enumerate(self.layers):
            if i in self.conf.input_preprocessors:
                x = self.conf.input_preprocessors[i].transform(x, mask)
            k = _key(i)
            if carries is not None and isinstance(layer, BaseRecurrent):
                x, carries[i] = layer.scan(self.params[k], x, carries[i],
                                           mask=mask)
            else:
                x, _ = layer.apply(self.params[k], x, state=self.state[k],
                                   train=False, mask=mask)
            if acts is not None:
                acts.append(x)
            mask = layer.propagate_mask(mask, self._input_types[i])
        return x

    def output(self, x) -> torch.Tensor:
        """Full forward pass (MultiLayerNetwork.output). `x` is an array or
        tensor in the JAX package's layout ([b, t] token ids for a
        TransformerLM), moved to the network's device; returns a tensor on
        that device."""
        with torch.inference_mode():
            return self._forward(self._as_input(x))

    def feed_forward(self, x) -> List[torch.Tensor]:
        """The input and every layer's activation, inference mode, as in
        the JAX package."""
        with torch.inference_mode():
            h = self._as_input(x)
            acts = [h]
            self._forward(h, acts=acts)
        return acts

    # ---- stateful RNN inference (rnnTimeStep) ----
    def _init_carries(self, batch: int, for_streaming: bool = False) -> list:
        """A zero (h, c) carry per recurrent layer, None elsewhere.
        for_streaming (rnn_time_step) rejects a layer that is not
        streamable: a bidirectional layer's backward scan needs the
        sequence end."""
        if for_streaming:
            for l in self.layers:
                if isinstance(l, BaseRecurrent) and not l.streamable:
                    raise ValueError(
                        f"{type(l).__name__} is bidirectional: rnnTimeStep "
                        f"needs a forward-only state carry (backward scan "
                        f"requires the sequence end)")
        return [l.init_carry(batch, self.device)
                if isinstance(l, BaseRecurrent) else None
                for l in self.layers]

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed one or more timesteps, carrying every recurrent layer's
        state across calls. x: [b, t, f], or [b, f] for a single step (then
        the result is [b, n_out]). Returns a tensor on the network's
        device."""
        with torch.inference_mode():
            x = self._as_input(x)
            single = x.dim() == 2
            if single:
                x = x[:, None, :]
            carries = self._rnn_carries
            if carries is None:
                carries = self._init_carries(x.shape[0], for_streaming=True)
            carries = list(carries)  # a failed call keeps the old state
            h = self._forward(x, carries=carries)
            self._rnn_carries = carries
        return h[:, 0] if single and h.dim() == 3 else h

    def get_param_table(self) -> Dict[str, np.ndarray]:
        """"layer_i/name" -> numpy array (paramTable()), nested params
        flattened with '/' ("layer_2/attn/Wqkv"). The JAX package's table
        keeps a nested dict as ONE entry ("layer_2/attn" -> a 0-d numpy
        object array holding the dict); flattening that dict the same way
        gives exactly this table."""
        flat = {}
        for i, layer in enumerate(self.layers):
            for path, t in flat_items(self.params[_key(i)]):
                t = layer.to_interchange(path, t)
                flat[f"{_key(i)}/{path}"] = t.detach().cpu().numpy()
        return flat
