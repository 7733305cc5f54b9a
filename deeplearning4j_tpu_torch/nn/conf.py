"""Configuration DSL: NeuralNetConfiguration (the network-wide defaults) and
MultiLayerConfiguration (the sequential network description); counterpart
of deeplearning4j_tpu/nn/conf.py, with its DL4J-style fluent
NeuralNetConfigurationBuilder (`NeuralNetConfiguration.builder()`).

"Config is data": every config round-trips through JSON, and the JSON of a
config is the same in both packages.

    conf = (NeuralNetConfiguration(seed=12)
            .list([EmbeddingSequence(n_in=1000, n_out=64),
                   TransformerBlock(n_heads=4, causal=True),
                   RnnOutput(n_out=1000)])
            .set_input_type(inputs.recurrent(1000, 128)))
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import schedules as sched_mod
from deeplearning4j_tpu_torch.nn import updaters as upd_mod
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.preprocessors import InputPreProcessor


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

    def list(self, layers: Optional[List[Layer]] = None
             ) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(defaults=self, layers=list(layers or []))

    def graph(self):
        from deeplearning4j_tpu_torch.nn.graph_conf import (
            ComputationGraphConfiguration)

        return ComputationGraphConfiguration(defaults=self)

    @staticmethod
    def builder() -> "NeuralNetConfigurationBuilder":
        return NeuralNetConfigurationBuilder()

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


class NeuralNetConfigurationBuilder:
    """DL4J-style fluent builder (NeuralNetConfiguration.Builder): any
    `.name(value)` sets that NeuralNetConfiguration field (a bare `.name()`
    sets True); `iterations` and `use_drop_connect` are DL4J's legacy
    no-ops."""

    def __init__(self):
        self._kw: Dict[str, Any] = {}

    def __getattr__(self, name):
        def setter(value=True):
            key = {
                "iterations": None,  # DL4J legacy no-op
                "use_drop_connect": None,
            }.get(name, name)
            if key is not None:
                self._kw[key] = value
            return self

        return setter

    def seed(self, s):
        self._kw["seed"] = int(s)
        return self

    def updater(self, u):
        self._kw["updater"] = u
        return self

    def build(self) -> NeuralNetConfiguration:
        return NeuralNetConfiguration(**self._kw)

    def list(self, layers=None) -> "MultiLayerConfiguration":
        return self.build().list(layers)


# sequence-first layer types: with no explicit input_type, an n_in on one
# of these implies a Recurrent (BTF) input; anything else FeedForward
_RNN_FIRST_LAYERS = ("LSTM", "GravesLSTM", "GravesBidirectionalLSTM",
                     "SimpleRnn", "Conv1D", "EmbeddingSequence")


def resolve_first_input_type(conf: "MultiLayerConfiguration") -> it.InputType:
    """Input type seen by layer 0: the explicit input_type, else inferred
    from the first layer's n_in. Raises ValueError when neither is there."""
    if conf.input_type is not None:
        return conf.input_type
    first = conf.layers[0]
    n_in = getattr(first, "n_in", None)
    if not n_in:
        raise ValueError(
            "No input_type set and first layer has no n_in; call "
            "set_input_type(...)")
    return (it.Recurrent(n_in)
            if type(first).__name__ in _RNN_FIRST_LAYERS
            else it.FeedForward(n_in))


@dataclass
class MultiLayerConfiguration:
    """Sequential network description (MultiLayerConfiguration.java).

    `input_preprocessors` maps a layer index to the InputPreProcessor
    applied to that layer's input (nn/preprocessors.py).
    """

    defaults: NeuralNetConfiguration = field(
        default_factory=NeuralNetConfiguration)
    layers: List[Layer] = field(default_factory=list)
    input_type: Optional[it.InputType] = None
    input_preprocessors: Dict[int, InputPreProcessor] = field(
        default_factory=dict)

    def layer(self, l: Layer) -> "MultiLayerConfiguration":
        self.layers.append(l)
        return self

    def input_preprocessor(self, idx: int, p: InputPreProcessor
                           ) -> "MultiLayerConfiguration":
        self.input_preprocessors[int(idx)] = p
        return self

    def set_input_type(self, input_type: it.InputType
                       ) -> "MultiLayerConfiguration":
        self.input_type = input_type
        return self

    # DL4J-style aliases (pretrain and backprop are no-ops: layerwise
    # pretraining is MultiLayerNetwork.pretrain)
    setInputType = set_input_type
    backprop = lambda self, *a, **k: self  # noqa: E731
    pretrain = lambda self, *a, **k: self  # noqa: E731

    def build(self) -> "MultiLayerConfiguration":
        self.validate()
        return self

    def validate(self):
        """Raise ValueError when the network has no layers, a preprocessor
        names no layer, or shapes do not infer. The JAX package's full
        analyzer (analysis/graph.py) is ported with the analysis slice."""
        if not self.layers:
            raise ValueError("MultiLayerConfiguration has no layers")
        bad = sorted(i for i in self.input_preprocessors
                     if not 0 <= i < len(self.layers))
        if bad:
            raise ValueError(f"input preprocessors at {bad} name no layer "
                             f"(network has {len(self.layers)})")
        self.layer_input_types()

    def layer_input_types(self) -> List[it.InputType]:
        """Input type seen by each layer (after its preprocessor), plus the
        final output type appended: len(layers) + 1 entries."""
        cur = resolve_first_input_type(self)
        types = []
        for i, layer in enumerate(self.layers):
            if i in self.input_preprocessors:
                cur = self.input_preprocessors[i].output_type(cur)
            types.append(cur)
            cur = layer.output_type(cur)
        types.append(cur)
        return types

    # ---- serde (the checkpoint `configuration.json` payload) ----
    def to_json(self) -> str:
        d = {
            "format": "deeplearning4j_tpu/MultiLayerConfiguration/v1",
            "defaults": self.defaults.to_json(),
            "layers": [l.to_json() for l in self.layers],
            "input_type": (self.input_type.to_json() if self.input_type
                           else None),
            "input_preprocessors": {
                str(k): v.to_json() for k, v in self.input_preprocessors.items()
            },
        }
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: Union[str, dict]) -> "MultiLayerConfiguration":
        d = json.loads(s) if isinstance(s, str) else s
        return cls(
            defaults=NeuralNetConfiguration.from_json(d["defaults"]),
            layers=[Layer.from_json(ld) for ld in d["layers"]],
            input_type=(it.from_json(d["input_type"]) if d.get("input_type")
                        else None),
            input_preprocessors={
                int(k): InputPreProcessor.from_json(v)
                for k, v in (d.get("input_preprocessors") or {}).items()
            },
        )

    # ---- resolved per-layer hyperparameters ----
    def resolved(self, i: int, attr: str, default=None):
        """Layer-level override else network default else `default`."""
        v = getattr(self.layers[i], attr, None)
        if v is None:
            v = getattr(self.defaults, attr, None)
        return default if v is None else v
