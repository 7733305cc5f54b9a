"""Output layer, inference part (counterpart of
deeplearning4j_tpu/nn/layers/output.py). `Output.apply` is the activation
(softmax by default) over `preout`; the loss contract, RnnOutput, LossLayer
and CenterLossOutput come with the training slice."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from deeplearning4j_tpu_torch.nn.layers.base import register_layer
from deeplearning4j_tpu_torch.nn.layers.dense import Dense


@register_layer
@dataclass
class Output(Dense):
    """Dense + loss (DL4J OutputLayer). Default act=softmax, loss=MCXENT."""

    loss: Optional[str] = None  # loss function name

    def apply(self, params, x, *, state, train, mask=None):
        return self.act_fn("softmax")(self.preout(params, x)), state
