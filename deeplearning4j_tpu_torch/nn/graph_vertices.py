"""Graph vertices for ComputationGraph: GraphVertex, LayerVertex,
ElementWiseVertex, MergeVertex, ReshapeVertex, PreprocessorVertex and the
combinators the DL4J importer creates: SubsetVertex, StackVertex,
UnstackVertex, L2Vertex, L2NormalizeVertex, ScaleVertex, ShiftVertex,
PoolHelperVertex and the recurrent LastTimeStepVertex and
DuplicateToTimeSeriesVertex (counterpart of
deeplearning4j_tpu/nn/graph_vertices.py).

A vertex is a function of its input tensors; a LayerVertex wraps any Layer
config (the graph analogue of a layer in MultiLayerConfiguration), a
PreprocessorVertex an InputPreProcessor. Both nest their object's JSON in
the vertex's. `propagate_mask` gives the time mask of a vertex's output
from its inputs' masks (None where there is none): by default the first
input's that has one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import weightnoise as wn_mod
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.recurrent import last_step
from deeplearning4j_tpu_torch.nn.preprocessors import InputPreProcessor

_TYPES: Dict[str, type] = {}


def register_vertex(cls):
    _TYPES[cls.__name__] = cls
    return cls


class GraphVertex:
    """Combinator: apply(params, inputs, ...) -> (out, new_state)."""

    #: True when the vertex computes per timestep or per feature, so the
    #: seq axis may shard its time axis; time-structural vertices
    #: (LastTimeStep, DuplicateToTimeSeries, Reshape, Stack/Unstack,
    #: preprocessors) keep False and are refused. LayerVertex defers to
    #: its layer's sp_safe.
    sp_safe = False

    def output_type(self, input_types: Sequence[it.InputType]) -> it.InputType:
        raise NotImplementedError

    def init_params(self, gen, input_types):
        return {}

    def init_state(self, input_types):
        return {}

    def has_params(self) -> bool:
        return False

    def apply(self, params, inputs: List[torch.Tensor], *, state, train,
              masks=None, rng=None):
        raise NotImplementedError

    def propagate_mask(self, masks, input_types):
        for m in (masks or []):
            if m is not None:
                return m
        return None

    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for k, v in self.__dict__.items():
            if isinstance(v, (Layer, InputPreProcessor)):
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
        if cls is PreprocessorVertex and isinstance(d.get("preprocessor"),
                                                    dict):
            d["preprocessor"] = InputPreProcessor.from_json(
                d["preprocessor"])
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

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        """The layer on the first input, its weight noise on its params
        first at train time (as the JAX package's LayerVertex)."""
        mask = masks[0] if masks else None
        params = wn_mod.maybe_transform(self.layer, params, rng, train)
        return self.layer.apply(params, inputs[0], state=state, train=train,
                                mask=mask, rng=rng)

    def propagate_mask(self, masks, input_types):
        m = masks[0] if masks else None
        return self.layer.propagate_mask(m, input_types[0])


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Add | Subtract | Product | Average | Max over same-shaped inputs."""

    sp_safe = True  # elementwise

    op: str = "add"

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
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


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the last axis: the channels of NHWC, the features
    of BTF and [b, f] (nn/conf/graph/MergeVertex.java)."""

    sp_safe = True  # feature-axis concat

    def output_type(self, input_types):
        t0 = input_types[0]
        if isinstance(t0, it.Convolutional):
            return it.Convolutional(t0.height, t0.width,
                                    sum(t.channels for t in input_types))
        if isinstance(t0, it.Recurrent):
            return it.Recurrent(sum(t.size for t in input_types),
                                t0.timesteps)
        return it.FeedForward(sum(t.arity() for t in input_types))

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return torch.cat(inputs, dim=-1), state


@register_vertex
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape to [batch, *new_shape] (nn/conf/graph/ReshapeVertex.java)."""

    new_shape: Sequence[int] = field(default_factory=tuple)

    def output_type(self, input_types):
        s = tuple(self.new_shape)
        if len(s) == 1:
            return it.FeedForward(s[0])
        if len(s) == 2:
            return it.Recurrent(s[1], s[0])
        if len(s) == 3:
            return it.Convolutional(s[0], s[1], s[2])
        raise ValueError(f"Bad reshape {s}")

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.new_shape)), state


@register_vertex
@dataclass
class PreprocessorVertex(GraphVertex):
    """Applies an InputPreProcessor (nn/conf/graph/PreprocessorVertex.java);
    the Keras importer makes one of a Flatten."""

    preprocessor: InputPreProcessor = None

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return self.preprocessor.transform(inputs[0]), state


@register_vertex
@dataclass
class SubsetVertex(GraphVertex):
    """Features [from_idx, to_idx], both ends included, of the last axis
    (nn/conf/graph/SubsetVertex.java)."""

    sp_safe = True  # feature-axis slice

    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        t0 = input_types[0]
        if isinstance(t0, it.Recurrent):
            return it.Recurrent(n, t0.timesteps)
        if isinstance(t0, it.Convolutional):
            return it.Convolutional(t0.height, t0.width, n)
        return it.FeedForward(n)

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1], state


@register_vertex
@dataclass
class StackVertex(GraphVertex):
    """Concatenation along the batch axis (nn/conf/graph/StackVertex.java)."""

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return torch.cat(inputs, dim=0), state


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """Batch segment `from_idx` of `stack_size` equal parts
    (nn/conf/graph/UnstackVertex.java)."""

    from_idx: int = 0
    stack_size: int = 1

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step], state


@register_vertex
@dataclass
class L2Vertex(GraphVertex):
    """Euclidean distance between two inputs, per example: [b, 1]
    (nn/conf/graph/L2Vertex.java)."""

    eps: float = 1e-8

    def output_type(self, input_types):
        return it.FeedForward(1)

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        a = inputs[0].reshape(inputs[0].shape[0], -1)
        b = inputs[1].reshape(inputs[1].shape[0], -1)
        d = a - b
        return torch.sqrt((d * d).sum(-1, keepdim=True) + self.eps), state


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over every axis but the batch
    (nn/conf/graph/L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt((flat * flat).sum(-1) + self.eps)
        return x / norm.reshape((x.shape[0],) + (1,) * (x.dim() - 1)), state


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    """x * scale_factor (nn/conf/graph/ScaleVertex.java)."""

    sp_safe = True  # elementwise

    scale_factor: float = 1.0

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return inputs[0] * self.scale_factor, state


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    """x + shift_factor (nn/conf/graph/ShiftVertex.java)."""

    sp_safe = True  # elementwise

    shift_factor: float = 0.0

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return inputs[0] + self.shift_factor, state


@register_vertex
@dataclass
class PoolHelperVertex(GraphVertex):
    """Drops the first row and column of NHWC activations (the legacy
    GoogLeNet import shim, nn/conf/graph/PoolHelperVertex.java)."""

    def output_type(self, input_types):
        t = input_types[0]
        return it.Convolutional(t.height - 1, t.width - 1, t.channels)

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return inputs[0][:, 1:, 1:, :], state


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """RNN [b, t, f] -> the last live step [b, f]
    (nn/conf/graph/rnn/LastTimeStepVertex.java), by its input's propagated
    mask (`recurrent.last_step`). `mask_input` names a graph input, as in
    the JAX package, which stores it and reads it nowhere: the runtime
    hands the vertex its input's mask (ROADMAP C.9)."""

    mask_input: Optional[str] = None

    def output_type(self, input_types):
        return it.FeedForward(input_types[0].size)

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        return last_step(inputs[0], masks[0] if masks else None), state

    def propagate_mask(self, masks, input_types):
        return None


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[b, f] -> [b, t, f], repeated over the time axis of the second input
    (nn/conf/graph/rnn/DuplicateToTimeSeriesVertex.java), whose mask the
    output takes."""

    def output_type(self, input_types):
        if len(input_types) != 2:
            # the JAX package's graph analyzer refuses it with a ValueError
            # too: the reference's one-input form (`inputName`) is not
            # translated (ROADMAP C.10)
            raise ValueError(
                f"DuplicateToTimeSeriesVertex takes 2 input(s) but is wired "
                f"to {len(input_types)}")
        t = (input_types[1].timesteps
             if isinstance(input_types[1], it.Recurrent) else -1)
        return it.Recurrent(input_types[0].arity(), t)

    def apply(self, params, inputs, *, state, train, masks=None,
              rng=None):
        x, ref = inputs
        return x[:, None, :].expand(x.shape[0], ref.shape[1],
                                    x.shape[-1]), state

    def propagate_mask(self, masks, input_types):
        return masks[1] if masks and len(masks) > 1 else None
