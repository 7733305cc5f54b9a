"""Output layers, inference part (counterpart of
deeplearning4j_tpu/nn/layers/output.py). `Output.apply` and `RnnOutput.apply`
are the activation (softmax by default) over `preout`; the loss contract,
LossLayer and CenterLossOutput come with the training slice."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import register_layer
from deeplearning4j_tpu_torch.nn.layers.dense import Dense
from deeplearning4j_tpu_torch.ops import linear as ops


@register_layer
@dataclass
class Output(Dense):
    """Dense + loss (DL4J OutputLayer). Default act=softmax, loss=MCXENT."""

    loss: Optional[str] = None  # loss function name

    def apply(self, params, x, *, state, train, mask=None):
        return self.act_fn("softmax")(self.preout(params, x)), state


@register_layer
@dataclass
class RnnOutput(Output):
    """Per-timestep output over [b, t, f] input (DL4J RnnOutputLayer):
    [b, t, n_out] probabilities."""

    def output_type(self, input_type):
        t = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(self.n_out, t)

    def preout(self, params, x):
        z = ops.dot(x, params["W"])  # [b, t, f] @ [f, n] -> [b, t, n]
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        return z
