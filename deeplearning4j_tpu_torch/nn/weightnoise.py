"""Weight noise: the IWeightNoise contract, DropConnect and WeightNoise
(counterpart of deeplearning4j_tpu/nn/weightnoise.py;
nn/conf/weightnoise/{IWeightNoise,DropConnect,WeightNoise}.java).

The reference draws noisy weights per forward pass at train time
(getParameter); here, as in the JAX package, it is a transform of a
layer's params dict made before the layer runs. Gradients flow straight
through the mask or the offset to the raw param, and the raw param is
never written: `fit` updates it in place afterwards.

Which params count as weights is the layer's `regularizable()` (the
weights-not-biases split of DL4J's ParamInitializer). The noise of the
j-th param in sorted key order comes from `rng.fold_in(j)` and is drawn in
the interchange layout (the JAX package's: Conv2D kernels HWIO); the noisy
param goes back to the port's layout through the layer's
`from_interchange`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn import schedules as sched_mod
from deeplearning4j_tpu_torch.nn.dropout import (
    _revive,
    _serde_value,
    inverted_dropout,
    scheduled,
)

_WEIGHT_NOISE_TYPES: Dict[str, type] = {}


def register_weight_noise(cls):
    _WEIGHT_NOISE_TYPES[cls.__name__] = cls
    return cls


@dataclass
class IWeightNoise:
    """Contract: transform one param at train time."""

    # keyword-only: DropConnect(0.9) means p=0.9, not apply_to_biases=0.9
    apply_to_biases: bool = field(default=False, kw_only=True)

    def apply(self, param: torch.Tensor, rng, iteration=None):
        raise NotImplementedError

    def transform(self, layer, params: dict, rng, iteration=None) -> dict:
        """`params` with noise on the weights (and on the biases with
        `apply_to_biases`); a new dict, the tensors given are not
        changed."""
        if not params:
            return params
        weight_keys = set(layer.regularizable(params).keys())
        out = {}
        for i, (k, v) in enumerate(sorted(params.items())):
            if k in weight_keys or self.apply_to_biases:
                noisy = self.apply(layer.to_interchange(k, v), rng.fold_in(i),
                                   iteration=iteration)
                out[k] = layer.from_interchange(k, noisy)
            else:
                out[k] = v
        return out

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = _serde_value(getattr(self, f.name))
        return d


def from_json(d: dict) -> IWeightNoise:
    d = {k: _revive(k, v) for k, v in d.items()}
    t = d.pop("type")
    return _WEIGHT_NOISE_TYPES[t](**d)


def maybe_transform(layer, params, rng, train: bool):
    """The one gate every runtime goes through (the MultiLayerNetwork's
    layers, a graph's LayerVertex, the output layers' loss): the layer's
    weight noise on its params at train time, at the iteration of the
    enclosing `iteration_scope`."""
    wn = getattr(layer, "weight_noise", None)
    if not train or wn is None or rng is None or not params:
        return params
    from deeplearning4j_tpu_torch.nn.layers.base import current_iteration

    return wn.transform(layer, params, rng.fold_in(997),
                        iteration=current_iteration())


@register_weight_noise
@dataclass
class DropConnect(IWeightNoise):
    """Inverted dropout on the weights; p = retain probability
    (DropConnect.java, kept weights scaled by 1/p)."""

    p: float = 0.5
    p_schedule: Optional[sched_mod.Schedule] = None

    def apply(self, param, rng, iteration=None):
        return inverted_dropout(
            param, scheduled(self.p, self.p_schedule, iteration), rng)


@register_weight_noise
@dataclass
class WeightNoise(IWeightNoise):
    """Additive or multiplicative gaussian noise on the weights
    (WeightNoise.java; the reference takes a Distribution, here the mean
    and standard deviation of a gaussian). Multiplicative noise is
    param * (mean + stddev·N), as in the JAX package."""

    mean: float = 0.0
    stddev: float = 0.1
    additive: bool = True

    def apply(self, param, rng, iteration=None):
        noise = self.mean + self.stddev * rng.normal(param.shape, param.dtype)
        if self.additive:
            return param + noise
        return param * noise
