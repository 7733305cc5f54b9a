"""Output and loss layers: Output, RnnOutput, LossLayer, CenterLossOutput
(counterpart of deeplearning4j_tpu/nn/layers/output.py).

An output layer is a Dense layer plus a loss contract:
    compute_loss(params, x, labels, *, state, mask) ->
        (mean_score, per_example, new_state)
`apply` is the activation (softmax by default) over `preout`.

The loss of Output and RnnOutput takes the fused linear + softmax
cross-entropy (ops/xent_kernel.py) under the JAX package's semantic
conditions: mcxent or negativeloglikelihood on a softmax, a 2-D W, shapes
that agree, and float32 or bfloat16 operands after the mixed-precision
cast. The JAX package also asks `xk.plan` (TPU VMEM budgets and tiling)
and the `DL4J_TPU_PALLAS_XENT` gate; neither is ported, as the char-RNN
slice dropped the LSTM kernel's gates: on a CUDA tensor the kernel always
runs, on a CPU tensor its plain version does. Anything else takes
`losses.compute` over the materialized pre-activation, and so does
CenterLossOutput, whose JAX counterpart calls it directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import losses as loss_mod
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.dense import Dense, _flatten_if_needed
from deeplearning4j_tpu_torch.ops import linear as ops
from deeplearning4j_tpu_torch.ops import xent_kernel as xk


class BaseOutputLayer(Layer):
    """Contract of the layers that end a network with a loss."""

    def compute_loss(self, params, x, labels, *, state, mask=None):
        """(mean_score, per_example_scores, new_state)."""
        raise NotImplementedError


@register_layer
@dataclass
class Output(Dense, BaseOutputLayer):
    """Dense + loss (DL4J OutputLayer). Default act=softmax, loss=MCXENT."""

    loss: Optional[str] = None  # loss function name

    # W and b split as Dense's, gathered whole on use: the fused loss
    # walks the whole vocabulary per row
    computes_model_shards = False

    def _loss_name(self):
        return self.loss or "mcxent"

    def _act(self):
        return self.act_fn("softmax")

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return self._act()(self.preout(params, x)), state

    def _fused_xent_per_example(self, params, x, labels):
        """Per-example scores through the fused linear + softmax-xent
        kernel, the [.., n_out] logits never materialized; None (the plain
        `losses.compute` path) unless the loss is mcxent/NLL on softmax with
        a 2-D W and shapes that agree."""
        if self._loss_name() not in ("mcxent", "negativeloglikelihood"):
            return None
        if not loss_mod._is_softmax(self._act()):
            return None
        W = params.get("W")
        if W is None or W.dim() != 2 or labels.dim() < 2:
            return None
        x2 = _flatten_if_needed(x)
        if (x2.shape[-1] != W.shape[0] or labels.shape[-1] != W.shape[1]
                or x2.shape[:-1] != labels.shape[:-1]):
            return None
        xc, Wc = ops._mixed_cast(x2, W)
        if xc.dtype not in (torch.float32, torch.bfloat16):
            return None
        if Wc.dtype != xc.dtype:  # the product promotes, as jnp.dot does
            common = torch.promote_types(xc.dtype, Wc.dtype)
            xc, Wc = xc.to(common), Wc.to(common)
        n = labels.shape[:-1].numel()
        bias = (params["b"] if self.has_bias and "b" in params
                else torch.zeros(Wc.shape[1], dtype=torch.float32,
                                 device=Wc.device))
        per_row = xk.linear_xent_rows(
            xc.reshape(n, xc.shape[-1]).contiguous(), Wc.contiguous(), bias,
            labels.reshape(n, labels.shape[-1]))
        return per_row.reshape(labels.shape[:-1])

    def compute_loss(self, params, x, labels, *, state, mask=None):
        per_example = self._fused_xent_per_example(params, x, labels)
        if per_example is not None:
            score, per_ex = loss_mod.reduce_score(per_example, mask)
            return score, per_ex, state
        z = self.preout(params, x)
        score, per_ex = loss_mod.compute(self._loss_name(), labels, z,
                                         self._act(), mask=mask)
        return score, per_ex, state


@register_layer
@dataclass
class RnnOutput(Output):
    """Per-timestep output over [b, t, f] input (DL4J RnnOutputLayer):
    [b, t, n_out] probabilities; the loss averages over batch * time, with
    masks."""

    def output_type(self, input_type):
        t = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(self.n_out, t)

    def preout(self, params, x):
        z = ops.dot(x, params["W"])  # [b, t, f] @ [f, n] -> [b, t, n]
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        return z


@register_layer
@dataclass
class LossLayer(BaseOutputLayer, Layer):
    """Loss without params: activation + loss on its input
    (nn/conf/layers/LossLayer.java)."""

    sp_safe = True  # per-slot loss; the seq step's counts span the shards

    loss: Optional[str] = None

    def output_type(self, input_type):
        return input_type

    def has_params(self):
        return False

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return self.act_fn("identity")(x), state

    def compute_loss(self, params, x, labels, *, state, mask=None):
        score, per_ex = loss_mod.compute(self.loss or "mcxent", labels, x,
                                         self.act_fn("identity"), mask=mask)
        return score, per_ex, state


@register_layer
@dataclass
class CenterLossOutput(Output):
    """Output layer with a center-loss term (nn/conf/layers/
    CenterLossOutputLayer.java):

        score = loss + lambda_ * 0.5 * mean_i ||x_i - c_{y_i}||^2

    The centers [n_out, n_in] are running state, not trained by the
    gradient: each step moves the center of every class in the batch by
    alpha times the mean of (x - c) over its rows (an EMA scatter-mean
    outside the gradient); classes absent from the batch keep theirs. The
    new centers leave through `compute_loss`'s new state."""

    sp_safe = False

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_state(self, input_type):
        return {"centers": torch.zeros(self.n_out,
                                       self.resolve_n_in(input_type))}

    def compute_loss(self, params, x, labels, *, state, mask=None):
        x2 = _flatten_if_needed(x)
        score, per_ex = loss_mod.compute(
            self._loss_name(), labels, self.preout(params, x2), self._act(),
            mask=mask)
        centers = state["centers"]
        cls = torch.argmax(labels, dim=-1)
        diff = x2 - centers[cls]
        shard = shard_mod.current()
        sq = torch.sum(diff * diff, dim=-1)
        # the mean over the rows and the scatter-mean over the global batch
        # in a data-parallel step: this rank's share of the mean, and every
        # rank's rows in each class's sum and count
        rows = sq.numel() * (1 if shard is None else shard.world)
        center_l = 0.5 * sq.sum() / rows
        with torch.no_grad():
            num = torch.zeros_like(centers).index_add_(
                0, cls, diff.detach().to(centers.dtype))
            cnt = torch.zeros(centers.shape[0], dtype=centers.dtype,
                              device=centers.device).index_add_(
                0, cls, torch.ones_like(cls, dtype=centers.dtype))
            if shard is not None:
                num, cnt = shard.all_sum(num), shard.all_sum(cnt)
            new_centers = centers + self.alpha * num / cnt.clamp_min(
                1.0)[:, None]
        return (score + self.lambda_ * center_l, per_ex,
                {"centers": new_centers})
