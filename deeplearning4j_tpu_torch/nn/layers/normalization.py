"""BatchNorm, inference mode (counterpart of
deeplearning4j_tpu/nn/layers/normalization.py; batch statistics, the EMA
update and LRN come with the training slice).

Running stats are STATE. The normalize + gamma/beta affine folds into one
per-channel float32 scale and shift, exactly as the JAX package folds them,
and the epilogue y = act(x * scale + shift) for relu/identity is the
hand-written CUDA kernel `ops.bn_act` on a CUDA tensor (its plain version on
a CPU tensor). Other activations take the plain epilogue, as in the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops.bn_act import bn_act


@register_layer
@dataclass
class BatchNorm(Layer):
    """gamma/beta trained; running mean/var tracked by EMA with `decay`
    (DL4J default decay=0.9, eps=1e-5; lockGammaBeta freezes scale/shift)."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0

    def _nf(self, input_type):
        if isinstance(input_type, it.Convolutional):
            return input_type.channels
        if isinstance(input_type, it.Recurrent):
            return input_type.size
        return input_type.arity()

    def output_type(self, input_type):
        return input_type

    def init_params(self, gen, input_type):
        n = self._nf(input_type)
        if self.lock_gamma_beta:
            return {}
        return {
            "gamma": torch.full((n,), float(self.gamma_init)),
            "beta": torch.full((n,), float(self.beta_init)),
        }

    def init_state(self, input_type):
        n = self._nf(input_type)
        return {"mean": torch.zeros(n), "var": torch.ones(n)}

    def fold(self, params, state):
        """Per-channel (scale, shift) of the inference epilogue, in the JAX
        package's order of operations."""
        inv = 1.0 / torch.sqrt(state["var"] + self.eps)
        scale, shift = inv, -state["mean"] * inv
        if not self.lock_gamma_beta:
            scale = scale * params["gamma"]
            shift = shift * params["gamma"] + params["beta"]
        return scale, shift

    def apply(self, params, x, *, state, train, mask=None):
        if train:
            raise NotImplementedError(
                "BatchNorm batch statistics come with the training slice; "
                "the port runs inference (train=False)")
        scale, shift = self.fold(params, state)
        return self._affine_act(x, scale, shift), state

    def _affine_act(self, x, scale, shift):
        act = self.activation if self.activation is not None else "identity"
        if act in ("relu", "identity") and x.dim() >= 2:
            return bn_act(x, scale, shift, act)
        y = x * scale.to(x.dtype) + shift.to(x.dtype)
        return self.act_fn("identity")(y)
