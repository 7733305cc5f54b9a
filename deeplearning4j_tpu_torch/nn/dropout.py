"""Dropout family: the IDropout contract, its four implementations and the
source of random numbers a training step draws from (counterpart of
deeplearning4j_tpu/nn/dropout.py; nn/conf/dropout/{IDropout,Dropout,
AlphaDropout,GaussianDropout,GaussianNoise}.java).

DL4J's `dropout(p)` convention: p is the RETAIN probability and the op is
inverted dropout (kept activations scaled by 1/p). A bare float in a layer
config means Dropout(p). Probability schedules (pSchedule, rateSchedule,
stddevSchedule) are any `nn.schedules.Schedule`, evaluated at the iteration
of the enclosing `layers.base.iteration_scope`.

Every draw goes through a `Draws` object, never through torch's global
generator. A network holds one, on its device, seeded from the
configuration's seed; each training step takes `draws.step()` and hands
the result down through `split` (one per layer or vertex) and `fold_in`
(weight noise: 997, then the index of the param), as the JAX package hands
down its PRNG keys. Here those calls return the same object, so the masks
come from one generator in the order the step asks for them. A replacement
with the same five methods can stand in for it (the tests replay the JAX
package's own keys through one; chip_smoke.py replays masks recorded on the
card); nothing else in the port knows which one it has.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn import schedules as sched_mod

_DROPOUT_TYPES: Dict[str, type] = {}


class Draws:
    """Random numbers for dropout masks and weight noise from one
    torch.Generator (on the device the tensors live on)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "Draws":
        return cls(torch.Generator(device=device).manual_seed(int(seed)))

    def step(self) -> "Draws":
        """The draws of one training step (JAX: `self._rng, sub =
        split(self._rng)`)."""
        return self

    def split(self, n: int):
        """One draws object per layer or vertex (JAX: `split(key, n)`)."""
        return [self] * n

    def fold_in(self, data: int) -> "Draws":
        """JAX: `fold_in(key, data)`."""
        return self

    def bernoulli(self, p, shape) -> torch.Tensor:
        """A bool mask, True with probability p (`uniform < p`). `p` is a
        number, or a tensor of probabilities of the mask's shape, each
        entry compared with its own uniform drawn in p's dtype (JAX:
        `bernoulli(key, p)` with an array p; the RBM's Gibbs samples)."""
        g = self.generator
        if isinstance(p, torch.Tensor):
            return torch.rand(shape, generator=g, device=g.device,
                              dtype=p.dtype) < p
        return torch.rand(shape, generator=g, device=g.device) < p

    def normal(self, shape, dtype) -> torch.Tensor:
        """Standard normal samples of `dtype`."""
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device, dtype=dtype)


class Recorded:
    """A step's draws that a recompute replays: the first pass through
    `inner` keeps every mask and noise sample it hands out; after
    `rewound()` the same calls get the same samples again, in order, and
    calls past the recorded ones draw anew (recorded too). A remat
    policy's checkpoint (`parallel.layout.maybe_remat`) reruns a layer's
    forward in the backward: torch.utils.checkpoint restores the default
    generators but not a network's own, so without the replay the
    recompute's masks would differ from the forward's."""

    def __init__(self, inner, tape=None):
        self.inner = inner
        self.tape = tape if tape is not None else {"samples": [], "pos": 0}

    def rewound(self) -> "Recorded":
        self.tape["pos"] = 0
        return self

    def _child(self, inner) -> "Recorded":
        return Recorded(inner, self.tape)

    def step(self):
        return self._child(self.inner.step())

    def split(self, n: int):
        return [self._child(d) for d in self.inner.split(n)]

    def fold_in(self, data: int):
        return self._child(self.inner.fold_in(data))

    def _take(self, draw):
        t = self.tape
        if t["pos"] < len(t["samples"]):
            out = t["samples"][t["pos"]]
        else:
            out = draw()
            t["samples"].append(out)
        t["pos"] += 1
        return out

    def bernoulli(self, p, shape) -> torch.Tensor:
        return self._take(lambda: self.inner.bernoulli(p, shape))

    def normal(self, shape, dtype) -> torch.Tensor:
        return self._take(lambda: self.inner.normal(shape, dtype))


def repeatable(rng):
    """A function returning `rng` (a step's draws) so that every call draws
    the same masks and noise: a line-search solver evaluates one
    iteration several times, and the JAX package hands every evaluation
    the same key. For a `Draws` the generator is set back to its state at
    this call before each return; a stand-in without a `generator` (the
    JAX keys replayed) already draws the same from one step's object."""
    gen = getattr(rng, "generator", None)
    if gen is None:
        return lambda: rng
    start = gen.get_state()

    def again():
        gen.set_state(start)
        return rng

    return again


def register_dropout(cls):
    _DROPOUT_TYPES[cls.__name__] = cls
    return cls


def scheduled(base, schedule: Optional[sched_mod.Schedule], iteration):
    """The value of a scheduled hyperparameter: `base` without a schedule
    or outside a training step, else schedule(base, iteration)."""
    if schedule is None or iteration is None:
        return base
    return schedule(base, iteration)


def scalar(v, dtype) -> torch.Tensor:
    """A Python number as a 0-d CPU tensor of `dtype`: rounded to `dtype`
    first, as the JAX package's `jnp.asarray(v, x.dtype)`, and an operand
    of arithmetic with a tensor on any device without a copy to it."""
    return torch.tensor(float(v), dtype=dtype)


def _serde_value(v):
    return v.to_json() if isinstance(v, sched_mod.Schedule) else v


def _revive(name: str, v):
    if name.endswith("_schedule") and isinstance(v, dict):
        return sched_mod.from_json(v)
    return v


@dataclass
class IDropout:
    """Dropout contract: a transform of activations at train time."""

    def apply(self, x: torch.Tensor, rng: Draws, iteration=None):
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = _serde_value(getattr(self, f.name))
        return d


def from_json(d: dict) -> IDropout:
    d = {k: _revive(k, v) for k, v in d.items()}
    t = d.pop("type")
    return _DROPOUT_TYPES[t](**d)


def resolve(value) -> Optional[IDropout]:
    """Layer config field -> IDropout; a float p is Dropout(p), and None
    outside (0, 1)."""
    if value is None:
        return None
    if isinstance(value, IDropout):
        return value
    p = float(value)
    if p <= 0.0 or p >= 1.0:
        return None
    return Dropout(p)


def inverted_dropout(x: torch.Tensor, p: float, rng: Draws) -> torch.Tensor:
    """Inverted dropout of x: where(keep, x / p, 0), p taken in x's
    dtype (not x * (1/p), which rounds differently in bfloat16)."""
    keep = rng.bernoulli(p, x.shape)
    return torch.where(keep, x / scalar(p, x.dtype), 0.0)


@register_dropout
@dataclass
class Dropout(IDropout):
    """Inverted dropout; p = retain probability (Dropout.java). `p_schedule`
    moves the retain probability over iterations."""

    p: float = 0.5
    p_schedule: Optional[sched_mod.Schedule] = None

    def apply(self, x, rng, iteration=None):
        p = scheduled(self.p, self.p_schedule, iteration)
        return inverted_dropout(x, p, rng)


@register_dropout
@dataclass
class AlphaDropout(IDropout):
    """SELU-preserving dropout (AlphaDropout.java):
    out = a·where(keep, x, α′) + b with α′ = −λα,
    a = (p + α′²·p(1−p))^(−1/2), b = −a·(1−p)·α′, which keeps SELU
    activations at zero mean and unit variance."""

    p: float = 0.5
    alpha: float = 1.6732632423543772
    lmbda: float = 1.0507009873554804
    p_schedule: Optional[sched_mod.Schedule] = None

    def _constants(self, p):
        ap = -self.lmbda * self.alpha
        a = (p + ap * ap * p * (1 - p)) ** -0.5
        b = -a * (1 - p) * ap
        return ap, a, b

    def apply(self, x, rng, iteration=None):
        p = scheduled(self.p, self.p_schedule, iteration)
        ap, a, b = self._constants(p)
        keep = rng.bernoulli(p, x.shape)
        mixed = torch.where(keep, x, scalar(ap, x.dtype).item())
        return scalar(a, x.dtype) * mixed + scalar(b, x.dtype)


@register_dropout
@dataclass
class GaussianDropout(IDropout):
    """Multiplicative gaussian noise N(1, sqrt(rate/(1−rate)))
    (GaussianDropout.java)."""

    rate: float = 0.1
    rate_schedule: Optional[sched_mod.Schedule] = None

    def apply(self, x, rng, iteration=None):
        rate = scheduled(self.rate, self.rate_schedule, iteration)
        std = (rate / (1.0 - rate)) ** 0.5
        noise = 1.0 + scalar(std, x.dtype) * rng.normal(x.shape, x.dtype)
        return x * noise


@register_dropout
@dataclass
class GaussianNoise(IDropout):
    """Additive gaussian noise N(0, stddev) (GaussianNoise.java)."""

    stddev: float = 0.1
    stddev_schedule: Optional[sched_mod.Schedule] = None

    def apply(self, x, rng, iteration=None):
        std = scheduled(self.stddev, self.stddev_schedule, iteration)
        return x + scalar(std, x.dtype) * rng.normal(x.shape, x.dtype)
