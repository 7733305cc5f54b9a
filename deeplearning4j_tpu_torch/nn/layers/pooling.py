"""GlobalPooling (counterpart of deeplearning4j_tpu/nn/layers/pooling.py):
CNN [b,h,w,c] -> [b,c] or RNN [b,t,f] -> [b,f] with MAX/AVG/SUM/PNORM.
Time masks come with the recurrent slice."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclass
class GlobalPooling(Layer):
    pooling_type: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self):
        return False

    def output_type(self, input_type):
        if isinstance(input_type, it.Convolutional):
            return it.FeedForward(input_type.channels)
        if isinstance(input_type, it.Recurrent):
            return it.FeedForward(input_type.size)
        return input_type

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        if x.dim() == 4:
            dims = (1, 2)
        elif x.dim() == 3:
            dims = (1,)
        else:
            return x, state
        if mask is not None and x.dim() == 3:
            raise NotImplementedError(
                "masked GlobalPooling comes with the recurrent slice")
        pt = self.pooling_type.lower()
        if pt == "max":
            y = torch.amax(x, dim=dims)
        elif pt in ("avg", "mean"):
            y = torch.mean(x, dim=dims)
        elif pt == "sum":
            y = torch.sum(x, dim=dims)
        elif pt == "pnorm":
            p = float(self.pnorm)
            y = torch.sum(torch.abs(x) ** p, dim=dims) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type {self.pooling_type}")
        return y, state
