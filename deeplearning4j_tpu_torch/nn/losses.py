"""Loss function registry (counterpart of deeplearning4j_tpu/nn/losses.py;
ND4J's `ILossFunction` surface).

Every loss is a function of (labels, activated output) giving the
per-element loss; `compute` reduces it to
    (mean_score, per_example)
where per_example sums the feature axis (DL4J computeScoreArray) and the
score is the mean over example slots (batch, and time for RNN outputs;
DL4J computeScore(..., average=true)). Gradients come from autograd through
these functions. Losses are taken in float32: a bfloat16 pre-activation
(the mixed-precision policy) is widened first. mcxent and
negativeloglikelihood on a softmax output use a fused log-softmax.

Masking: a mask broadcastable to per_example zeroes masked slots and the
mean divides by the active count (at least 1), as DL4J's masked averaging
does. In a data-parallel step (`nn.shard.current()`) the count is the
global batch's, so each rank's score is its share of the global mean.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from deeplearning4j_tpu_torch.nn import shard as shard_mod

EPS = 1e-7

# loss_fn(labels, output_activations) -> per-element loss, labels' shape
_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(f):
        _REGISTRY[name.lower()] = f
        return f

    return deco


def get(name_or_fn: Union[str, Callable]) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower().replace("lossfunction.", "")
    aliases = {
        "negativeloglikelihood": "mcxent",
        "reconstruction_crossentropy": "xent",
        "squared_loss": "mse",
    }
    key = aliases.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)


@register("mse")
def mse(labels, y):
    d = y - labels
    return d * d


@register("l2")
def l2(labels, y):
    # DL4J LossL2: sum of squared errors; the elementwise form of mse
    d = y - labels
    return d * d


@register("l1")
def l1(labels, y):
    return (y - labels).abs()


@register("mae")
def mae(labels, y):
    return (y - labels).abs()


@register("xent")
def xent(labels, y):
    """Binary cross-entropy on sigmoid (or any (0, 1)) outputs."""
    yc = y.clamp(EPS, 1.0 - EPS)
    return -(labels * torch.log(yc) + (1.0 - labels) * torch.log1p(-yc))


@register("mcxent")
def mcxent(labels, y):
    """Multi-class cross-entropy on probabilities: -t * log(p)."""
    return -labels * torch.log(y.clamp(EPS, 1.0))


@register("kl_divergence")
@register("kld")
def kld(labels, y):
    lc = labels.clamp(EPS, 1.0)
    yc = y.clamp(EPS, 1.0)
    return labels * (torch.log(lc) - torch.log(yc))


@register("poisson")
def poisson(labels, y):
    yc = y.clamp_min(EPS)
    return yc - labels * torch.log(yc)


@register("mape")
def mape(labels, y):
    return 100.0 * ((y - labels) / labels.abs().clamp_min(EPS)).abs()


@register("msle")
def msle(labels, y):
    d = torch.log1p(y.clamp_min(-1 + EPS)) - torch.log1p(
        labels.clamp_min(-1 + EPS))
    return d * d


@register("hinge")
def hinge(labels, y):
    # labels in {-1, +1}; {0, 1} accepted (0 counts as -1)
    t = torch.where(labels <= 0, -1.0, 1.0).to(y.dtype)
    return (1.0 - t * y).clamp_min(0.0)


@register("squared_hinge")
def squared_hinge(labels, y):
    h = hinge(labels, y)
    return h * h


@register("cosine_proximity")
def cosine_proximity(labels, y):
    # per-row loss -cos(labels, y), spread over the row for shape parity
    num = (labels * y).sum(dim=-1, keepdim=True)
    den = (torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
           * torch.linalg.vector_norm(y, dim=-1, keepdim=True))
    cos = num / den.clamp_min(EPS)
    return -cos * torch.ones_like(y) / y.shape[-1]


@register("expll")
def expll(labels, y):
    """Exponential log-likelihood (legacy DL4J LossFunction.EXPLL)."""
    yc = y.clamp_min(EPS)
    return yc - labels * torch.log(yc)


@register("wasserstein")
def wasserstein(labels, y):
    return labels * y


def compute(loss: Union[str, Callable], labels: torch.Tensor,
            preout: torch.Tensor, activation_fn: Callable,
            mask: Optional[torch.Tensor] = None,
            weights: Optional[torch.Tensor] = None):
    """(mean_score, per_example_score); per_example has labels.shape[:-1]
    (feature axis summed), as DL4J computeScoreArray."""
    name = loss if isinstance(loss, str) else getattr(loss, "__name__", "")
    if isinstance(name, str):
        name = name.lower()
    # losses always in float32 (bf16 activations reach the output layer
    # under the mixed policy; log-softmax in bf16 is unusable)
    if preout.dtype == torch.bfloat16:
        preout = preout.float()
    if name in ("mcxent", "negativeloglikelihood") and _is_softmax(
            activation_fn):
        per_elem = -labels * torch.log_softmax(preout, dim=-1)
    else:
        per_elem = get(loss)(labels, activation_fn(preout))
    if weights is not None:
        per_elem = per_elem * weights
    return reduce_score(per_elem.sum(dim=-1), mask)


def reduce_score(per_example: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
    """Masked mean of per-example scores: the shared tail of `compute`,
    also used by the fused loss path, which gives per-example scores
    without a [.., features] tensor. In a data-parallel step the mean is
    over the global batch's slots (every rank holds as many rows)."""
    shard = shard_mod.current()
    if mask is not None:
        m = mask
        # drop trailing singleton feature axes ([b, t, 1] masks)
        while m.dim() > per_example.dim() and m.shape[-1] == 1:
            m = m[..., 0]
        m = torch.broadcast_to(m, per_example.shape).to(per_example.dtype)
        per_example = per_example * m
        count = m.sum() if shard is None else shard.all_sum(m.sum())
        return per_example.sum() / count.clamp_min(1.0), per_example
    if shard is not None:
        return (per_example.sum() / (per_example.numel() * shard.world),
                per_example)
    # mean over all example slots (batch, and time for RNN outputs)
    return per_example.mean(), per_example


def _is_softmax(fn) -> bool:
    from deeplearning4j_tpu_torch.nn import activations as act_mod

    return fn is act_mod._REGISTRY.get("softmax")
