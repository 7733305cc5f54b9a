"""Memory estimation reports (counterpart of deeplearning4j_tpu/nn/memory.py;
nn/conf/memory/{MemoryReport,LayerMemoryReport,NetworkMemoryReport}).

Per-layer and network totals for parameters, activations and the training
working set, from a configuration: the JAX package's arithmetic, number
for number. `memory_report(conf)` counts each layer's params by drawing
them on the CPU from a throwaway generator, one layer at a time, each
freed before the next; nothing is allocated on the card. The updater's
slots per parameter are keyed on the port's updater class names, which
are the JAX package's.

The figures are a model of the working set, not a measurement: the card's
own peak (`torch.cuda.max_memory_allocated`) also counts whatever else is
alive there (the data, other networks) and the tensors the autograd graph
saves beyond one activation per layer, which the model does not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import updaters as upd_mod

# optimizer state slots per parameter (nn/updater semantics)
_UPDATER_SLOTS = {
    "Sgd": 0, "NoOp": 0, "Adam": 2, "AdaMax": 2, "Nadam": 2,
    "AdaDelta": 2, "Nesterovs": 1, "AdaGrad": 1, "RmsProp": 1,
}


@dataclass
class LayerMemoryReport:
    name: str
    layer_type: str
    params: int
    activation_elems_per_example: int

    def param_bytes(self, dtype_bytes: int = 4) -> int:
        return self.params * dtype_bytes

    def activation_bytes(self, batch: int, dtype_bytes: int = 4) -> int:
        return self.activation_elems_per_example * batch * dtype_bytes


@dataclass
class NetworkMemoryReport:
    layers: List[LayerMemoryReport]
    updater_slots: int

    @property
    def total_params(self) -> int:
        return sum(l.params for l in self.layers)

    def inference_bytes(self, batch: int, dtype_bytes: int = 4) -> int:
        """Params + the widest single activation."""
        widest = max((l.activation_bytes(batch, dtype_bytes)
                      for l in self.layers), default=0)
        return self.total_params * dtype_bytes + widest

    def remat_activation_factor(self, remat) -> float:
        """Modeled fraction of the full activation stash a remat policy
        keeps: 'none' (or False) 1, 'dots_saveable' 2/3, 'offload' 0.1,
        'full' (or True) 2*sqrt(n)/n capped at 1/2 for n layers; ValueError
        for another name."""
        if remat is None or remat is False:
            name = "none"
        elif remat is True:
            name = "full"
        else:
            name = str(remat)
        if name == "none":
            return 1.0
        if name == "dots_saveable":
            return 2.0 / 3.0
        if name == "offload":
            return 0.1
        if name == "full":
            n = max(1, len(self.layers))
            return min(2.0 * np.sqrt(n) / n, 0.5)
        raise ValueError(f"unknown remat policy {remat!r}")

    def training_bytes(self, batch: int, dtype_bytes: int = 4,
                       remat=False, *, mesh_spec=None,
                       fsdp: Optional[int] = None) -> int:
        """Params + grads + updater state + cached activations (all
        layers), per device.

        remat       activation-checkpoint policy name (or bool):
                    activations shrink by `remat_activation_factor`.
        mesh_spec   an object with `fsdp`, `model` and `dcn` sizes (a
                    `parallel.mesh.MeshSpec`, read through getattr): the
                    param, gradient and updater terms divide by fsdp *
                    model, the gradient term also by dcn; activations stay
                    per device (batch is the per-device batch).
        fsdp        explicit fsdp shard count; overrides mesh_spec's.
        """
        p = self.total_params * dtype_bytes
        shards = 1
        dcn = 1
        if mesh_spec is not None:
            shards = (max(1, getattr(mesh_spec, "fsdp", 1))
                      * max(1, getattr(mesh_spec, "model", 1)))
            dcn = max(1, getattr(mesh_spec, "dcn", 1))
        if fsdp is not None:
            shards = max(1, fsdp) * (
                max(1, getattr(mesh_spec, "model", 1))
                if mesh_spec is not None else 1)
        acts = sum(l.activation_bytes(batch, dtype_bytes)
                   for l in self.layers)
        if self.layers:
            acts = int(acts * self.remat_activation_factor(remat))
        # params + updater slots, plus the dcn-sharded gradient term:
        # exactly p*(2+slots)//shards when dcn is 1
        return (p * (1 + self.updater_slots) + p // dcn) // shards + acts

    def to_json(self) -> dict:
        return {
            "total_params": self.total_params,
            "updater_slots": self.updater_slots,
            "layers": [{"name": l.name, "type": l.layer_type,
                        "params": l.params,
                        "activation_elems_per_example":
                            l.activation_elems_per_example}
                       for l in self.layers],
        }

    def summary(self, batch: int = 32) -> str:
        lines = [f"{'layer':<28}{'type':<24}{'params':>12}{'act/ex':>12}"]
        for l in self.layers:
            lines.append(f"{l.name:<28}{l.layer_type:<24}{l.params:>12,}"
                         f"{l.activation_elems_per_example:>12,}")
        mb = 1024 * 1024
        lines.append(
            f"total params {self.total_params:,} | inference(b={batch}) "
            f"{self.inference_bytes(batch) / mb:.1f} MiB | train "
            f"{self.training_bytes(batch) / mb:.1f} MiB | train+remat "
            f"{self.training_bytes(batch, remat=True) / mb:.1f} MiB")
        return "\n".join(lines)


def _count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_params(v) for v in tree.values())
    return int(tree.numel())


def memory_report(conf) -> NetworkMemoryReport:
    """A NetworkMemoryReport of a MultiLayerConfiguration (getMemoryReport
    in the reference's config classes). Params are counted from each
    layer's `init_params` on the CPU, never on the card."""
    gen = torch.Generator().manual_seed(0)
    reports = []
    types = conf.layer_input_types()  # per-layer inputs + final output
    for i, layer in enumerate(conf.layers):
        in_type = types[i]
        params = layer.init_params(gen, in_type) if layer.has_params() \
            else {}
        reports.append(LayerMemoryReport(
            name=layer.name or f"layer_{i}",
            layer_type=type(layer).__name__,
            params=_count_params(params),
            activation_elems_per_example=layer.output_type(in_type).arity(),
        ))
    upd = upd_mod.get(conf.defaults.updater)
    slots = _UPDATER_SLOTS.get(type(upd).__name__, 2)
    return NetworkMemoryReport(reports, slots)
