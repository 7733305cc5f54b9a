"""Weight initialization schemes (counterpart of
deeplearning4j_tpu/nn/initializers.py).

The 21-scheme DL4J `WeightInit` enum with DL4J fan conventions: dense
[nIn, nOut] has fanIn=nIn, fanOut=nOut; conv kernels in the HWIO
interchange shape [kh, kw, cin, cout] have fanIn=cin*kh*kw,
fanOut=cout*kh*kw. Callers pass the interchange shape; layers that hold
another layout transpose the result.

Random draws come from an explicit `torch.Generator` on the CPU, so a seed
gives the same weights whichever device the network then lives on. The
streams cannot match `jax.random`: the schemes agree with the JAX package
in distribution, not bit for bit. All results are float32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

_F32 = torch.float32


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, dtype=_F32)


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, dtype=_F32) * (hi - lo) + lo


def compute_fans(shape: Sequence[int]) -> tuple[float, float]:
    """(fan_in, fan_out) per DL4J convention (see module docstring)."""
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = 1.0
    for s in shape[:-2]:
        receptive *= s
    return shape[-2] * receptive, shape[-1] * receptive


def init(
    scheme: str,
    gen: torch.Generator,
    shape: Sequence[int],
    fan_in: Optional[float] = None,
    fan_out: Optional[float] = None,
    distribution: Optional[dict] = None,
) -> torch.Tensor:
    """Materialize CPU float32 weights for `scheme` (case-insensitive
    WeightInit name), drawing from `gen`."""
    s = str(scheme).lower()
    if fan_in is None or fan_out is None:
        fi, fo = compute_fans(shape)
        fan_in = fan_in if fan_in is not None else fi
        fan_out = fan_out if fan_out is not None else fo

    shape = tuple(int(x) for x in shape)

    if s == "zero":
        return torch.zeros(shape, dtype=_F32)
    if s == "ones":
        return torch.ones(shape, dtype=_F32)
    if s == "constant":
        value = (distribution or {}).get("value", 0.0)
        return torch.full(shape, float(value), dtype=_F32)
    if s == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires square 2d shape")
        return torch.eye(shape[0], dtype=_F32)
    if s == "normal":
        # DL4J NORMAL: N(0, 1/sqrt(fanIn))
        return _normal(gen, shape) / math.sqrt(fan_in)
    if s == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, -a, a)
    if s == "xavier":
        return _normal(gen, shape) * math.sqrt(2.0 / (fan_in + fan_out))
    if s == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -a, a)
    if s in ("xavier_fan_in", "lecun_normal"):
        return _normal(gen, shape) * math.sqrt(1.0 / fan_in)
    if s == "xavier_legacy":
        return _normal(gen, shape) * math.sqrt(1.0 / (fan_in + fan_out))
    if s == "relu":
        return _normal(gen, shape) * math.sqrt(2.0 / fan_in)
    if s == "relu_uniform":
        a = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, -a, a)
    if s == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -a, a)
    if s == "lecun_uniform":
        a = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, -a, a)
    if s.startswith("var_scaling"):
        mode = s.replace("var_scaling_", "")
        if "fan_in" in mode:
            n = fan_in
        elif "fan_out" in mode:
            n = fan_out
        else:  # fan_avg
            n = 0.5 * (fan_in + fan_out)
        if "uniform" in mode:
            a = math.sqrt(3.0 / n)
            return _uniform(gen, shape, -a, a)
        return _normal(gen, shape) * math.sqrt(1.0 / n)
    if s == "distribution":
        return _from_distribution(gen, shape, distribution or {})
    raise ValueError(f"Unknown weight init scheme '{scheme}'")


def _from_distribution(gen, shape, dist: dict) -> torch.Tensor:
    """DL4J `Distribution` configs: normal/gaussian, uniform, binomial."""
    kind = str(dist.get("type", dist.get("distribution", "normal"))).lower()
    if kind in ("normal", "gaussian"):
        mean = float(dist.get("mean", 0.0))
        std = float(dist.get("std", 1.0))
        return mean + std * _normal(gen, shape)
    if kind == "uniform":
        return _uniform(gen, shape, float(dist.get("lower", -1.0)),
                        float(dist.get("upper", 1.0)))
    if kind == "binomial":
        n = int(dist.get("trials", 1))
        p = float(dist.get("prob", 0.5))
        probs = torch.full(shape, p, dtype=_F32)
        return torch.binomial(torch.full(shape, float(n), dtype=_F32), probs,
                              generator=gen)
    raise ValueError(f"Unknown distribution {dist}")

