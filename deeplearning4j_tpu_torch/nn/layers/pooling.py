"""GlobalPooling (counterpart of deeplearning4j_tpu/nn/layers/pooling.py):
CNN [b,h,w,c] -> [b,c] or RNN [b,t,f] -> [b,f] with MAX/AVG/SUM/PNORM,
over the live steps of a time mask as the JAX package pools them: masked
steps contribute nothing, AVG divides by the live count (at least 1) and
MAX gives -inf for a row with no live step."""
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

    def propagate_mask(self, mask, input_type):
        return None  # pooling consumes the time axis

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        if x.dim() == 4:
            dims = (1, 2)
        elif x.dim() == 3:
            dims = (1,)
        else:
            return x, state
        pt = self.pooling_type.lower()
        if mask is not None and x.dim() == 3:
            return self._masked(x, mask, pt), state
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

    def _masked(self, x, mask, pt):
        m = mask
        while m.dim() < x.dim():
            m = m[..., None]
        m = torch.broadcast_to(m, x.shape).to(x.dtype)
        if pt == "max":
            return torch.amax(torch.where(m > 0, x, torch.full_like(
                x, -float("inf"))), dim=1)
        if pt in ("avg", "mean"):
            return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        if pt == "sum":
            return (x * m).sum(dim=1)
        p = float(self.pnorm)
        return ((x.abs() ** p) * m).sum(dim=1) ** (1.0 / p)
