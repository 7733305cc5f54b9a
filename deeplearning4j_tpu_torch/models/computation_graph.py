"""ComputationGraph — DAG network runtime, inference part (counterpart of
deeplearning4j_tpu/models/computation_graph.py; fit, losses, tBPTT and
rnn_time_step come with later slices).

The topological order is computed once from the config; a forward walks it
eagerly, vertex by vertex, under `torch.inference_mode()`. Params and
running state are plain dicts of tensors per vertex name, with the JAX
package's names, on the device `init` was given.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import LayerVertex

Params = Dict[str, torch.Tensor]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    # torch.from_numpy cannot share a read-only buffer
    return torch.from_numpy(x if x.flags.writeable else x.copy())


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration):
        conf.validate()
        self.conf = conf
        self.topo = conf.topological_order()
        self.vertex_types = conf.vertex_output_types()
        self.params: Optional[Dict[str, Params]] = None
        self.state: Optional[Dict[str, Params]] = None
        self.device: Optional[torch.device] = None
        self._vin_types = {name: self._in_types(name) for name in self.topo}

    def _in_types(self, name):
        types = dict(zip(self.conf.network_inputs, self.conf.input_types))
        types.update(self.vertex_types)
        return [types[i] for i in self.conf.vertex_inputs[name]]

    def init(self, device=None) -> "ComputationGraph":
        """Random params from `conf.defaults.seed` (one CPU torch.Generator
        drawn in topological order, so a seed gives the same weights on
        every device), running state at its defaults, all on `device`
        (default: the CUDA card; pass device="cpu" for the CPU)."""
        self.device = device_mod.resolve(device)
        gen = torch.Generator().manual_seed(int(self.conf.defaults.seed))
        self.params, self.state = {}, {}
        for name in self.topo:
            v = self.conf.vertices[name]
            in_types = self._vin_types[name]
            p = v.init_params(gen, in_types) if v.has_params() else {}
            self.params[name] = {k: t.to(self.device) for k, t in p.items()}
            self.state[name] = {k: t.to(self.device)
                                for k, t in v.init_state(in_types).items()}
        return self

    def layer(self, name: str):
        """The Layer config of a LayerVertex (None for other vertices)."""
        v = self.conf.vertices[name]
        return v.layer if isinstance(v, LayerVertex) else None

    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params.values()
                       for t in p.values()))

    def _as_inputs(self, inputs) -> List[torch.Tensor]:
        if self.params is None:
            raise RuntimeError("call init() before running the network")
        return [_as_tensor(x).to(self.device) for x in inputs]

    def _forward(self, inputs: Sequence[torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Inference forward over the DAG: every vertex's activation (masks
        come with the recurrent slice)."""
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs,
                                                 inputs))
        for name in self.topo:
            v = self.conf.vertices[name]
            acts[name], _ = v.apply(
                self.params[name],
                [acts[x] for x in self.conf.vertex_inputs[name]],
                state=self.state[name], train=False)
        return acts

    def output(self, *inputs):
        """Forward to all output vertices. Inputs are arrays or tensors in
        the JAX package's layout (NHWC for images); they are moved to the
        network's device. Returns a tensor on that device (a list when the
        graph has several outputs)."""
        with torch.inference_mode():
            acts = self._forward(self._as_inputs(inputs))
        outs = [acts[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *inputs) -> List[torch.Tensor]:
        """Input + vertex activations in topological order (inputs lead),
        inference mode, as in the JAX package."""
        with torch.inference_mode():
            arrs = self._as_inputs(inputs)
            acts = self._forward(arrs)
        return list(arrs) + [acts[name] for name in self.topo]

    def get_param_table(self) -> Dict[str, np.ndarray]:
        """"vertex/param" -> numpy array in the interchange layout (the JAX
        package's: conv kernels HWIO), so both packages' tables compare."""
        flat = {}
        for name in self.topo:
            layer = self.layer(name)
            for pname, t in self.params[name].items():
                if layer is not None:
                    t = layer.to_interchange(pname, t)
                flat[f"{name}/{pname}"] = t.detach().cpu().numpy()
        return flat
