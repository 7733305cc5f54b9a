"""Activation function registry (counterpart of
deeplearning4j_tpu/nn/activations.py).

Configs name activations by string (DL4J's `Activation` enum); each resolves
to a function on tensors. Every function is elementwise except `softmax` and
`logsoftmax` (last axis). Each matches its jax.nn counterpart, including
gelu's tanh approximation (jax.nn.gelu's default).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, ActivationFn] = {}


def register(name: str, fn: Optional[ActivationFn] = None):
    def deco(f):
        _REGISTRY[name.lower()] = f
        return f

    if fn is not None:
        return deco(fn)
    return deco


def get(name_or_fn: Union[str, ActivationFn, None]) -> ActivationFn:
    """Resolve an activation by name (or pass through a callable)."""
    if name_or_fn is None:
        return _REGISTRY["identity"]
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key.startswith("leakyrelu:"):
        # parametric alpha encoded in the name so configs stay serializable
        return leaky_relu_with(float(key.split(":", 1)[1]))
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown activation '{name_or_fn}'. Known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)


register("identity", lambda x: x)
register("linear", lambda x: x)
register("relu", torch.relu)
register("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
register("sigmoid", torch.sigmoid)
register("tanh", torch.tanh)
register("softmax", lambda x: torch.softmax(x, dim=-1))
register("logsoftmax", lambda x: torch.log_softmax(x, dim=-1))
register("softplus", F.softplus)
register("softsign", F.softsign)
register("elu", F.elu)
register("selu", F.selu)
register("gelu", lambda x: F.gelu(x, approximate="tanh"))
register("swish", F.silu)
register("silu", F.silu)
register("mish", F.mish)
register("hardsigmoid", F.hardsigmoid)
register("hardtanh", lambda x: torch.clamp(x, -1.0, 1.0))
# ND4J 'cube' activation: f(x) = x^3
register("cube", lambda x: x * x * x)
# ND4J 'rationaltanh': 1.7159 * tanh(2x/3) approximation family
register("rationaltanh", lambda x: 1.7159 * torch.tanh((2.0 / 3.0) * x))
register("rectifiedtanh", lambda x: torch.clamp_min(torch.tanh(x), 0.0))
register("thresholdedrelu",
         lambda x: torch.where(x > 1.0, x, torch.zeros_like(x)))
# Keras 'exponential' activation (positive-output heads, Poisson regression)
register("exp", torch.exp)


@register("leakyrelu")
def leakyrelu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, alpha * x)


def leaky_relu_with(alpha: float) -> ActivationFn:
    return lambda x: leakyrelu(x, alpha)
