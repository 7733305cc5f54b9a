"""Feed-forward layers, the part ResNet-50 runs: Dense and Activation
(counterpart of deeplearning4j_tpu/nn/layers/dense.py; the embeddings,
ElementWiseMultiplication and DropoutLayer come with later slices).

Params follow DL4J naming: W [nIn, nOut], b [nOut] — the same layout in
both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import initializers as init_mod
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops import linear as ops


def _flatten_if_needed(x):
    """CNN input into a dense layer is flattened (NHWC order, as the JAX
    package does); 3d [b,t,f] input stays, the matmul runs per timestep."""
    if x.dim() == 4:
        return x.reshape(x.shape[0], -1)
    return x


@register_layer
@dataclass
class Dense(Layer):
    """Fully connected: y = act(x @ W + b)."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, input_type):
        if isinstance(input_type, it.Recurrent):
            return it.Recurrent(self.n_out, input_type.timesteps)
        return it.FeedForward(self.n_out)

    def resolve_n_in(self, input_type):
        if self.n_in:
            return self.n_in
        if isinstance(input_type, it.Recurrent):
            return input_type.size
        return input_type.arity()

    def init_params(self, gen, input_type):
        n_in = self.resolve_n_in(input_type)
        p = {"W": init_mod.init(self.weight_init or "xavier", gen,
                                (n_in, self.n_out), distribution=self.dist)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0))
        return p

    def preout(self, params, x):
        z = ops.dot(_flatten_if_needed(x), params["W"])
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        return z

    def apply(self, params, x, *, state, train, mask=None):
        return self.act_fn("sigmoid")(self.preout(params, x)), state


@register_layer
@dataclass
class Activation(Layer):
    """Parameterless activation layer (nn/conf/layers/ActivationLayer.java)."""

    def output_type(self, input_type):
        return input_type

    def has_params(self):
        return False

    def apply(self, params, x, *, state, train, mask=None):
        return self.act_fn("identity")(x), state
