"""Configuration DSL: NeuralNetConfiguration, the network-wide defaults
(counterpart of deeplearning4j_tpu/nn/conf.py; MultiLayerConfiguration and
the fluent builder come with the MultiLayerNetwork slice).

"Config is data": every config round-trips through JSON, and the JSON of a
config is the same in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

from deeplearning4j_tpu_torch.nn import schedules as sched_mod
from deeplearning4j_tpu_torch.nn import updaters as upd_mod


@dataclass
class NeuralNetConfiguration:
    """Global (network-wide) hyperparameter defaults; every field can be
    overridden per-layer (Layer fields of the same name)."""

    seed: int = 0
    updater: Union[upd_mod.Updater, str] = "sgd"
    learning_rate: Optional[float] = None  # overrides updater's lr if set
    lr_schedule: Optional[sched_mod.Schedule] = None
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    optimization_algo: str = "stochastic_gradient_descent"
    max_num_line_search_iterations: int = 5
    mini_batch: bool = True
    # tBPTT (BackpropType.TruncatedBPTT; MultiLayerConfiguration fields)
    backprop_type: str = "standard"  # standard | tbptt
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def __post_init__(self):
        if isinstance(self.updater, str):
            self.updater = upd_mod.get(self.updater)
        if self.learning_rate is not None:
            self.updater.learning_rate = self.learning_rate

    def graph(self):
        from deeplearning4j_tpu_torch.nn.graph_conf import (
            ComputationGraphConfiguration)

        return ComputationGraphConfiguration(defaults=self)

    # ---- serde ----
    def to_json(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (upd_mod.Updater, sched_mod.Schedule)):
                v = v.to_json()
            d[f.name] = v
        return d

    @classmethod
    def from_json(cls, d: dict) -> "NeuralNetConfiguration":
        d = dict(d)
        if isinstance(d.get("updater"), dict):
            d["updater"] = upd_mod.from_json(d["updater"])
        if isinstance(d.get("lr_schedule"), dict):
            d["lr_schedule"] = sched_mod.from_json(d["lr_schedule"])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
