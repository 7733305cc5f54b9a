"""Learning-rate schedule configs (counterpart of
deeplearning4j_tpu/nn/schedules.py; DL4J `LearningRatePolicy`).

Only the configs and their JSON form are ported with the serving slice:
a `NeuralNetConfiguration` carries its `lr_schedule` through serde. The
schedules' values as functions of the iteration come with the training
slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


class Schedule:
    """Base schedule config."""

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        d.update(self.__dict__)
        return d


@dataclass
class NoneSchedule(Schedule):
    pass


@dataclass
class ExponentialSchedule(Schedule):
    decay_rate: float = 0.99


@dataclass
class InverseSchedule(Schedule):
    gamma: float = 1e-3
    power: float = 1.0


@dataclass
class PolySchedule(Schedule):
    power: float = 1.0
    max_iter: int = 10000


@dataclass
class SigmoidSchedule(Schedule):
    gamma: float = 1e-2
    step_size: int = 1000


@dataclass
class StepSchedule(Schedule):
    decay_rate: float = 0.1
    step_size: int = 1000


@dataclass
class TorchStepSchedule(Schedule):
    decay_rate: float = 0.1
    step_size: int = 1000


@dataclass
class MapSchedule(Schedule):
    """DL4J `learningRateSchedule(Map<Integer,Double>)`: piecewise-constant
    lr set at given iterations."""

    schedule: Dict[int, float] = field(default_factory=dict)


@dataclass
class WarmupCosineSchedule(Schedule):
    """Linear warmup then cosine decay."""

    warmup_steps: int = 1000
    total_steps: int = 100000
    final_fraction: float = 0.0


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
