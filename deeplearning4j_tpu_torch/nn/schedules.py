"""Learning-rate schedules (counterpart of deeplearning4j_tpu/nn/schedules.py;
DL4J `LearningRatePolicy`).

Each schedule is a config (JSON form shared with the JAX package) and a
function `schedule(lr, iteration, epoch=0)` giving the learning rate at an
iteration, as a Python float computed in double precision (the JAX
package's jnp math gives float32, or float64 under x64: the two differ by
float32 rounding only). The training loop reads it on the host, once per
step, from its Python iteration count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


class Schedule:
    """Base schedule: __call__(lr, iteration, epoch=0) -> learning rate."""

    def __call__(self, lr, iteration, epoch=0):
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        d.update(self.__dict__)
        return d


@dataclass
class NoneSchedule(Schedule):
    def __call__(self, lr, iteration, epoch=0):
        return lr


@dataclass
class ExponentialSchedule(Schedule):
    decay_rate: float = 0.99

    def __call__(self, lr, iteration, epoch=0):
        return lr * self.decay_rate ** iteration


@dataclass
class InverseSchedule(Schedule):
    gamma: float = 1e-3
    power: float = 1.0

    def __call__(self, lr, iteration, epoch=0):
        return lr / (1.0 + self.gamma * iteration) ** self.power


@dataclass
class PolySchedule(Schedule):
    power: float = 1.0
    max_iter: int = 10000

    def __call__(self, lr, iteration, epoch=0):
        return lr * (1.0 - _clip01(iteration / self.max_iter)) ** self.power


@dataclass
class SigmoidSchedule(Schedule):
    gamma: float = 1e-2
    step_size: int = 1000

    def __call__(self, lr, iteration, epoch=0):
        return lr / (1.0 + math.exp(self.gamma * (iteration
                                                  - self.step_size)))


@dataclass
class StepSchedule(Schedule):
    decay_rate: float = 0.1
    step_size: int = 1000

    def __call__(self, lr, iteration, epoch=0):
        return lr * self.decay_rate ** math.floor(iteration / self.step_size)


@dataclass
class TorchStepSchedule(Schedule):
    decay_rate: float = 0.1
    step_size: int = 1000

    def __call__(self, lr, iteration, epoch=0):
        return lr * self.decay_rate ** math.floor(
            (iteration + 1) / self.step_size)


@dataclass
class MapSchedule(Schedule):
    """DL4J `learningRateSchedule(Map<Integer,Double>)`: piecewise-constant
    lr set at given iterations."""

    schedule: Dict[int, float] = field(default_factory=dict)

    def __call__(self, lr, iteration, epoch=0):
        out = lr
        for it in sorted(self.schedule):
            if iteration >= it:
                out = self.schedule[it]
        return out


@dataclass
class WarmupCosineSchedule(Schedule):
    """Linear warmup then cosine decay."""

    warmup_steps: int = 1000
    total_steps: int = 100000
    final_fraction: float = 0.0

    def __call__(self, lr, iteration, epoch=0):
        if iteration < self.warmup_steps:
            return lr * _clip01(iteration / max(self.warmup_steps, 1))
        prog = _clip01((iteration - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1))
        return lr * (self.final_fraction + (1 - self.final_fraction) * 0.5
                     * (1 + math.cos(math.pi * prog)))


_TYPES = {
    c.__name__: c
    for c in [
        NoneSchedule, ExponentialSchedule, InverseSchedule, PolySchedule,
        SigmoidSchedule, StepSchedule, TorchStepSchedule, MapSchedule,
        WarmupCosineSchedule,
    ]
}


def from_json(d: Optional[dict]) -> Schedule:
    if d is None:
        return NoneSchedule()
    d = dict(d)
    t = d.pop("type")
    cls = _TYPES[t]
    if cls is MapSchedule and "schedule" in d:
        d["schedule"] = {int(k): float(v) for k, v in d["schedule"].items()}
    return cls(**d)
