"""Updater configs (counterpart of deeplearning4j_tpu/nn/updaters.py).

The 8 rules of DL4J's `Updater` enum plus NoOp, with DL4J default
hyperparameters. This slice of the port serves models and does not train
them, so only the configs that `NeuralNetConfiguration` and the zoo
construct are here, with their JSON form; the update rules themselves come
with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from deeplearning4j_tpu_torch.nn import schedules as sched_mod


class Updater:
    """Base updater config."""

    name: str = "base"

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for k, v in self.__dict__.items():
            if isinstance(v, sched_mod.Schedule):
                d[k] = v.to_json()
            else:
                d[k] = v
        return d


@dataclass
class Sgd(Updater):
    learning_rate: float = 1e-1
    name: str = field(default="sgd", repr=False)


@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name: str = field(default="adam", repr=False)


@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name: str = field(default="adamax", repr=False)


@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6
    learning_rate: float = 1.0  # AdaDelta ignores lr in DL4J; kept for API parity
    name: str = field(default="adadelta", repr=False)


@dataclass
class Nesterovs(Updater):
    learning_rate: float = 1e-1
    momentum: float = 0.9
    name: str = field(default="nesterovs", repr=False)


@dataclass
class Nadam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name: str = field(default="nadam", repr=False)


@dataclass
class AdaGrad(Updater):
    learning_rate: float = 1e-1
    epsilon: float = 1e-6
    name: str = field(default="adagrad", repr=False)


@dataclass
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    name: str = field(default="rmsprop", repr=False)


@dataclass
class NoOp(Updater):
    """DL4J Updater.NONE — gradient applied raw (lr=1) or frozen layers."""

    learning_rate: float = 1.0
    name: str = field(default="none", repr=False)


_TYPES = {
    c.__name__: c
    for c in [Sgd, Adam, AdaMax, AdaDelta, Nesterovs, Nadam, AdaGrad, RmsProp, NoOp]
}
_BY_NAME = {
    "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "adadelta": AdaDelta,
    "nesterovs": Nesterovs, "nadam": Nadam, "adagrad": AdaGrad,
    "rmsprop": RmsProp, "none": NoOp, "noop": NoOp,
}


def get(u) -> Updater:
    if isinstance(u, Updater):
        return u
    if isinstance(u, str):
        key = u.lower()
        if key not in _BY_NAME:
            raise ValueError(f"Unknown updater '{u}'. Known: {sorted(_BY_NAME)}")
        return _BY_NAME[key]()
    raise TypeError(f"Cannot resolve updater from {u!r}")


def from_json(d: dict) -> Updater:
    d = dict(d)
    t = d.pop("type")
    d.pop("name", None)
    return _TYPES[t](**d)
