"""BatchNorm and LRN (counterpart of
deeplearning4j_tpu/nn/layers/normalization.py).

Running stats are STATE. In training (`train=True`) the batch statistics
over every axis but the last are taken in float32 (a bfloat16 x is widened
inside the reduction) in the stable two-reduce form E[(x - mean)^2], and the
new running stats are the EMA `decay * old + (1 - decay) * batch` (biased
variance), detached; at inference the running stats are used. Under the
data-parallel wrapper the batch statistics are the global batch's
(`batch_stats`), so the running stats move alike on every rank. Either way
the normalize + gamma/beta affine folds into one per-channel float32 scale
and shift, in the JAX package's order of operations, and the epilogue
y = act(x * scale + shift) for relu/identity on a float32 or bfloat16 x is
the hand-written CUDA kernel `ops.bn_act` on a CUDA tensor (its plain
version on a CPU tensor); its gradients reach x, gamma, beta and the batch
statistics through the plain epilogue. Other activations and dtypes take
the plain epilogue, as in the JAX package.

LRN, the cross-channel local response normalization of AlexNet-era nets
(the DL4J importer creates it), is plain PyTorch on NHWC with the JAX
package's order of operations; it has no kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops import bn_act as bn_ops


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

    def fold(self, params, mean, var):
        """Per-channel (scale, shift) of the epilogue from the statistics
        `mean`, `var`, in the JAX package's order of operations."""
        inv = 1.0 / torch.sqrt(var + self.eps)
        scale, shift = inv, -mean * inv
        if not self.lock_gamma_beta:
            scale = scale * params["gamma"]
            shift = shift * params["gamma"] + params["beta"]
        return scale, shift

    def regularizable(self, params):
        return {}

    def batch_stats(self, x):
        """(mean, biased var) over every axis but the last, float32 for a
        bfloat16 x, in the two-reduce form. In a data-parallel step they
        are the global batch's: each sum is all-reduced, differentiably, so
        the statistics' gradients reach every rank's rows."""
        dims = tuple(range(x.dim() - 1))
        acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        shard = shard_mod.current()
        if shard is None:
            mean = x.mean(dims, dtype=acc)
            var = ((x.to(acc) - mean) ** 2).mean(dims)
            return mean, var
        n = x.numel() // x.shape[-1] * shard.world
        mean = shard.all_sum_grad(x.sum(dims, dtype=acc)) / n
        var = shard.all_sum_grad(((x.to(acc) - mean) ** 2).sum(dims)) / n
        return mean, var

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        if train:
            mean, var = self.batch_stats(x)
            d = self.decay
            new_state = {
                "mean": (d * state["mean"] + (1 - d) * mean).detach(),
                "var": (d * state["var"] + (1 - d) * var).detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        scale, shift = self.fold(params, mean, var)
        return self._affine_act(x, scale, shift), new_state

    def _affine_act(self, x, scale, shift):
        act = self.activation if self.activation is not None else "identity"
        if act in ("relu", "identity") and x.dim() >= 2 and \
                x.dtype in bn_ops.DTYPES:
            return bn_ops.bn_act(x, scale, shift, act)
        y = x * scale.to(x.dtype) + shift.to(x.dtype)
        return self.act_fn("identity")(y)


@register_layer
@dataclass
class LRN(Layer):
    """Local response normalization across channels
    (nn/conf/layers/LocalResponseNormalization.java; DL4J defaults k=2, n=5,
    alpha=1e-4, beta=0.75): x / (k + alpha * sum of x^2 over the `n`
    channels centred on each one) ** beta, channels last."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def has_params(self):
        return False

    def output_type(self, input_type):
        return input_type

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        half = int(self.n) // 2
        c = x.shape[-1]
        padded = torch.nn.functional.pad(x * x, (half, half))
        # the window's terms added one by one, as the JAX package adds them
        acc = torch.zeros_like(x)
        for i in range(int(self.n)):
            acc = acc + padded[..., i:i + c]
        return x / (self.k + self.alpha * acc) ** self.beta, state
