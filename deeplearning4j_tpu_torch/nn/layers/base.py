"""Layer protocol: config + compute in one serializable object (counterpart
of deeplearning4j_tpu/nn/layers/base.py).

Each layer is ONE dataclass whose fields are its JSON config and whose
methods compute on tensors:

    output_type(input)            InputType propagation
    init_params(gen, input)       dict of CPU float32 tensors, in the port's
                                  layout, drawn from a torch.Generator
    init_state(input)             running state (BN stats); {} if none
    apply(params, x, *, state, train, mask) -> (y, new_state)
    propagate_mask(mask, input)   the mask the next layer sees

Params are held as plain dicts of tensors per vertex, keyed by the JAX
package's names ("W", "b", "gamma", ...); a layer made of sublayers
(TransformerBlock) nests dicts the same way. Where the port keeps a param in
another memory layout than the interchange form (Conv2D holds OIHW weights
for cuDNN, the interchange form is HWIO), the layer converts in
`from_interchange` / `to_interchange`; nothing else knows the layout.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters as upd_mod

Params = Dict[str, torch.Tensor]

_LAYER_TYPES: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator: adds the layer to the serde registry."""
    _LAYER_TYPES[cls.__name__] = cls
    return cls


@dataclass
class Layer:
    """Base layer config. The fields are the JAX package's, so a config's
    JSON reads the same in both packages. Training reads the updater,
    learning rate, l1/l2, gradient normalization and constraints; dropout
    and weight noise are not ported yet (fit refuses a network that asks
    for them), remat is carried for the JAX package."""

    # --- per-layer overrides (None = inherit from NeuralNetConfiguration) ---
    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    updater: Optional[Any] = None          # Updater | str
    learning_rate: Optional[float] = None  # per-layer lr override
    dropout: Optional[Any] = None          # float retain-prob | dropout config
    weight_noise: Optional[Any] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    dist: Optional[dict] = None            # for weight_init == DISTRIBUTION
    constraints: Optional[list] = None
    remat: Optional[str] = None

    # ---- shape/param/compute protocol ----
    def output_type(self, input_type: it.InputType) -> it.InputType:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator,
                    input_type: it.InputType) -> Params:
        return {}

    def init_state(self, input_type: it.InputType) -> Params:
        return {}

    def apply(self, params: Params, x: torch.Tensor, *, state: Params,
              train: bool, mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Params]:
        raise NotImplementedError

    def has_params(self) -> bool:
        return True

    def regularizable(self, params: Params) -> Params:
        """Params subject to l1/l2 weight decay (default: every key except
        biases)."""
        return {k: v for k, v in params.items() if not k.startswith("b")}

    def propagate_mask(self, mask: Optional[torch.Tensor],
                       input_type: it.InputType) -> Optional[torch.Tensor]:
        """The mask the next layer sees (DL4J feedForwardMaskArray);
        default passthrough."""
        return mask

    # ---- param layout (interchange form = the JAX package's layout) ----
    def from_interchange(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """A param in the interchange layout -> the layout `apply` uses."""
        return value

    def to_interchange(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """Inverse of `from_interchange`."""
        return value

    # ---- config resolution helpers ----
    def act_fn(self, default: str = "identity") -> Callable:
        a = self.activation if self.activation is not None else default
        return act_mod.get(a)

    # ---- serde ----
    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if hasattr(v, "to_json") and not isinstance(v, (str, int, float)):
                v = v.to_json()
            d[f.name] = v
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Layer":
        d = dict(d)
        t = d.pop("type")
        if t not in _LAYER_TYPES:
            raise ValueError(f"layer type {t!r} is not ported yet; ported: "
                             f"{sorted(_LAYER_TYPES)}")
        target = _LAYER_TYPES[t]
        if isinstance(d.get("updater"), dict):
            d["updater"] = upd_mod.from_json(d["updater"])
        field_names = {f.name for f in dataclasses.fields(target)}
        kwargs = {k: v for k, v in d.items() if k in field_names}
        obj = target(**kwargs)
        # tuple-ify list fields that started as tuples
        for f in dataclasses.fields(target):
            v = getattr(obj, f.name)
            if isinstance(v, list) and f.name in ("kernel_size", "stride", "padding", "dilation", "size", "pooling_dimensions"):
                setattr(obj, f.name, tuple(v))
        return obj
