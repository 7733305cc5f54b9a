"""ComputationGraphConfiguration — serializable DAG description
(counterpart of deeplearning4j_tpu/nn/graph_conf.py).

API:
    conf = (NeuralNetConfiguration(seed=1).graph()
            .add_inputs("in")
            .add_layer("dense1", Dense(n_out=64, activation="relu"), "in")
            .add_layer("out", Output(n_out=10), "dense1")
            .set_outputs("out")
            .set_input_types(inputs.feed_forward(784)))

`validate()` checks what a forward needs: every input a vertex names
exists, the graph is acyclic, the outputs exist, and shapes infer. The JAX
package's full analyzer (analysis/graph.py) is ported with the analysis
slice.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Union

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import layers as _layers  # noqa: F401 (fills the layer registry from_json reads)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import GraphVertex, LayerVertex
from deeplearning4j_tpu_torch.nn.layers.base import Layer


def kahn_order(vertices, vertex_inputs):
    """FIFO Kahn's algorithm over vertex names; deterministic (insertion
    order). Returns (order, leftover) where `leftover` is the unsortable
    (cyclic) remainder; inputs naming no vertex are ignored."""
    indeg = {n: 0 for n in vertices}
    consumers: Dict[str, List[str]] = {n: [] for n in vertices}
    for name, ins in vertex_inputs.items():
        if name not in indeg:
            continue
        indeg[name] = sum(1 for i in ins if i in indeg)
        for i in ins:
            if i in indeg:
                consumers[i].append(name)
    ready = [n for n, d in indeg.items() if d == 0]
    order: List[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for c in consumers[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    return order, set(vertices) - set(order)


@dataclass
class ComputationGraphConfiguration:
    defaults: NeuralNetConfiguration = field(default_factory=NeuralNetConfiguration)
    network_inputs: List[str] = field(default_factory=list)
    vertices: Dict[str, GraphVertex] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    network_outputs: List[str] = field(default_factory=list)
    input_types: List[it.InputType] = field(default_factory=list)

    # ---- builder API ----
    def add_inputs(self, *names: str) -> "ComputationGraphConfiguration":
        self.network_inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str):
        layer.name = layer.name or name
        return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str):
        if name in self.vertices or name in self.network_inputs:
            raise ValueError(f"Duplicate vertex name '{name}'")
        self.vertices[name] = vertex
        self.vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str):
        self.network_outputs = list(names)
        return self

    def set_input_types(self, *types: it.InputType):
        self.input_types = list(types)
        return self

    def build(self) -> "ComputationGraphConfiguration":
        self.validate()
        return self

    # ---- analysis ----
    def validate(self):
        """Raise ValueError on dangling inputs, cycles, unknown outputs or
        shapes that do not infer."""
        known = set(self.network_inputs) | set(self.vertices)
        for name, ins in self.vertex_inputs.items():
            missing = [i for i in ins if i not in known]
            if missing:
                raise ValueError(f"vertex '{name}' reads unknown inputs "
                                 f"{missing}")
        for name in self.network_outputs:
            if name not in self.vertices:
                raise ValueError(f"network output '{name}' is not a vertex")
        self.vertex_output_types()

    def topological_order(self) -> List[str]:
        """kahn_order over this graph's wiring; raises on cycles."""
        order, leftover = kahn_order(self.vertices, self.vertex_inputs)
        if leftover:
            raise ValueError(
                f"graph has a cycle involving {sorted(leftover)}")
        return order

    def vertex_output_types(self) -> Dict[str, it.InputType]:
        """Shape inference over the DAG (InputTypeUtil analogue)."""
        types: Dict[str, it.InputType] = {}
        if self.input_types:
            for name, t in zip(self.network_inputs, self.input_types):
                types[name] = t
        else:
            raise ValueError("set_input_types(...) required for shape inference")
        for name in self.topological_order():
            v = self.vertices[name]
            ins = [types[i] for i in self.vertex_inputs[name]]
            types[name] = v.output_type(ins)
        return types

    # ---- serde ----
    def to_json(self) -> str:
        d = {
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration/v1",
            "defaults": self.defaults.to_json(),
            "network_inputs": self.network_inputs,
            "vertices": {k: v.to_json() for k, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "network_outputs": self.network_outputs,
            "input_types": [t.to_json() for t in self.input_types],
        }
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: Union[str, dict]) -> "ComputationGraphConfiguration":
        d = json.loads(s) if isinstance(s, str) else s
        return cls(
            defaults=NeuralNetConfiguration.from_json(d["defaults"]),
            network_inputs=list(d["network_inputs"]),
            vertices={k: GraphVertex.from_json(v) for k, v in d["vertices"].items()},
            vertex_inputs={k: list(v) for k, v in d["vertex_inputs"].items()},
            network_outputs=list(d["network_outputs"]),
            input_types=[it.from_json(t) for t in d.get("input_types", [])],
        )
