"""Graph vertices for ComputationGraph, the part ResNet-50 runs: GraphVertex,
LayerVertex and ElementWiseVertex (counterpart of
deeplearning4j_tpu/nn/graph_vertices.py; Merge, Subset, Stack and the other
combinators come with later slices).

A vertex is a function of its input tensors; a LayerVertex wraps any Layer
config (the graph analogue of a layer in MultiLayerConfiguration).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import Layer

_TYPES: Dict[str, type] = {}


def register_vertex(cls):
    _TYPES[cls.__name__] = cls
    return cls


class GraphVertex:
    """Combinator: apply(params, inputs, ...) -> (out, new_state)."""

    def output_type(self, input_types: Sequence[it.InputType]) -> it.InputType:
        raise NotImplementedError

    def init_params(self, gen, input_types):
        return {}

    def init_state(self, input_types):
        return {}

    def has_params(self) -> bool:
        return False

    def apply(self, params, inputs: List[torch.Tensor], *, state, train,
              masks=None):
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for k, v in self.__dict__.items():
            if isinstance(v, Layer):
                v = v.to_json()
            d[k] = v
        return d

    @staticmethod
    def from_json(d: dict) -> "GraphVertex":
        d = dict(d)
        t = d.pop("type")
        if t not in _TYPES:
            raise ValueError(f"vertex type {t!r} is not ported yet; ported: "
                             f"{sorted(_TYPES)}")
        cls = _TYPES[t]
        if cls is LayerVertex and isinstance(d.get("layer"), dict):
            d["layer"] = Layer.from_json(d["layer"])
        return cls(**d)


@register_vertex
@dataclass
class LayerVertex(GraphVertex):
    """Wraps a Layer config (nn/graph/vertex/impl/LayerVertex.java)."""

    layer: Layer = None

    def output_type(self, input_types):
        return self.layer.output_type(input_types[0])

    def init_params(self, gen, input_types):
        return self.layer.init_params(gen, input_types[0])

    def init_state(self, input_types):
        return self.layer.init_state(input_types[0])

    def has_params(self):
        return self.layer.has_params()

    def apply(self, params, inputs, *, state, train, masks=None):
        mask = masks[0] if masks else None
        return self.layer.apply(params, inputs[0], state=state, train=train,
                                mask=mask)


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Add | Subtract | Product | Average | Max over same-shaped inputs."""

    op: str = "add"

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, inputs, *, state, train, masks=None):
        op = self.op.lower()
        if op == "add":
            out = sum(inputs[1:], inputs[0])
        elif op == "subtract":
            out = inputs[0] - inputs[1]
        elif op in ("product", "mult"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
        elif op in ("average", "avg"):
            out = sum(inputs[1:], inputs[0]) / len(inputs)
        elif op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"Unknown elementwise op {self.op}")
        return out, state
