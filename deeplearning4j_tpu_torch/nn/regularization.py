"""Parameter constraints, applied after each update (counterpart of the
constraint half of deeplearning4j_tpu/nn/regularization.py;
nn/conf/constraint/{MaxNorm,MinMaxNorm,UnitNorm,NonNegative}Constraint.java
applied via Model.applyConstraints). Weight noise (DropConnect,
WeightNoise) lives in nn/weightnoise.py.

Norms run over every axis but the last (for a dense W [n_in, n_out]: per
output unit); constraints apply to weights, not to params whose name starts
with "b", except NonNegative, which applies to all. The port also descends
into nested params (a TransformerBlock's "attn" dict), constraining each
leaf by its own name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

_TYPES: Dict[str, type] = {}


def register_constraint(cls):
    _TYPES[cls.__name__] = cls
    return cls


class Constraint:
    """apply(param) -> constrained param."""

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def applies_to(self, param_name: str) -> bool:
        # DL4J constraints apply to weights by default, biases optionally
        return not param_name.startswith("b")

    def to_json(self):
        d = {"type": type(self).__name__}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_json(d: dict) -> "Constraint":
        d = dict(d)
        t = d.pop("type")
        return _TYPES[t](**d)


def _norm(p: torch.Tensor) -> torch.Tensor:
    axes = tuple(range(p.dim() - 1)) if p.dim() > 1 else (0,)
    return torch.sqrt((p * p).sum(dim=axes, keepdim=True))


@register_constraint
@dataclass
class MaxNorm(Constraint):
    max_norm: float = 2.0

    def apply(self, p):
        scale = (self.max_norm / _norm(p).clamp_min(1e-12)).clamp_max(1.0)
        return p * scale


@register_constraint
@dataclass
class MinMaxNorm(Constraint):
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0

    def apply(self, p):
        n = _norm(p)
        clipped = n.clamp(self.min_norm, self.max_norm)
        target = self.rate * clipped + (1 - self.rate) * n
        return p * target / n.clamp_min(1e-12)


@register_constraint
@dataclass
class UnitNorm(Constraint):
    def apply(self, p):
        return p / _norm(p).clamp_min(1e-12)


@register_constraint
@dataclass
class NonNegative(Constraint):
    def apply(self, p):
        return p.clamp_min(0.0)

    def applies_to(self, param_name):
        return True


def apply_constraints(params: dict,
                      constraints: Optional[Sequence]) -> dict:
    """A new params dict with every applicable constraint applied in
    order; constraint configs may be objects or their JSON dicts."""
    if not constraints:
        return params
    cs = [Constraint.from_json(c) if isinstance(c, dict) else c
          for c in constraints]
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = apply_constraints(v, cs)
            continue
        for c in cs:
            if c.applies_to(k):
                v = c.apply(v)
        out[k] = v
    return out
