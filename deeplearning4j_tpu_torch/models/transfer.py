"""Transfer learning: graft, freeze and modify trained networks
(counterpart of deeplearning4j_tpu/models/transfer.py).

Reference: nn/transferlearning/TransferLearning.java:847 (Builder:
setFeatureExtractor, removeOutputLayer, nOutReplace, addLayer),
FineTuneConfiguration.java (override global hyperparameters),
TransferLearningHelper.java (featurize through the frozen layers once,
train only the unfrozen tail).

Params are nested dicts of tensors, so grafting copies a layer's dict;
frozen layers are wrapped in `nn.layers.misc.Frozen`, which the
MultiLayerNetwork's step leaves out of the gradient and the updater. The
networks `build` and `unfrozen_network` make live on the source network's
device (the JAX package calls `init()` with no device, which in the port
would mean the card).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import _training as tr
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork,
    _key,
)
from deeplearning4j_tpu_torch.nn import updaters as upd_mod
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.misc import Frozen


@dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides applied to every retained layer
    (nn/transferlearning/FineTuneConfiguration.java)."""

    updater: Optional[Any] = None
    learning_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    activation: Optional[str] = None
    seed: Optional[int] = None

    def apply_to(self, defaults: NeuralNetConfiguration):
        d = copy.deepcopy(defaults)
        for f in ("updater", "l1", "l2", "dropout", "activation", "seed"):
            v = getattr(self, f)
            if v is not None:
                setattr(d, f, v)
        if self.learning_rate is not None:
            d.updater = upd_mod.get(d.updater)
            d.updater.learning_rate = self.learning_rate
        return d


def _same_shapes(a, b) -> bool:
    """Whether two param trees hold the same names with the same shapes
    (the JAX package compares tree structures, whose dict keys sort)."""
    def shapes(tree):
        return {path: tuple(t.shape) for path, t in tr.flat_items(tree)}

    return shapes(a) == shapes(b)


class TransferLearning:
    """Fluent edits of an initialized MultiLayerNetwork, applied by
    `build` to a new network (TransferLearning.Builder)."""

    def __init__(self, net: MultiLayerNetwork):
        self._net = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._n_out_replace: Dict[int, int] = {}
        self._remove_from: Optional[int] = None
        self._added: List[Layer] = []

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_idx: int):
        """Freeze layers [0, layer_idx] (TransferLearning.setFeatureExtractor)."""
        self._freeze_until = layer_idx
        return self

    def n_out_replace(self, layer_idx: int, n_out: int):
        """Replace a layer's output size (re-initializing it and the next
        layer's fan-in)."""
        self._n_out_replace[layer_idx] = n_out
        return self

    def remove_output_layer(self):
        return self.remove_layers_from_output(len(self._net.layers) - 1)

    def remove_layers_from_output(self, idx: int):
        self._remove_from = idx
        return self

    def add_layer(self, layer: Layer):
        self._added.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        """The new network on the source's device: retained layers copied
        (frozen ones wrapped in Frozen) with their params and running
        state, re-initialized and added layers drawn from the seed."""
        src = self._net
        layers: List[Layer] = []
        keep = len(src.layers) if self._remove_from is None else self._remove_from
        reinit: set = set()
        for i in range(keep):
            layer = copy.deepcopy(src.layers[i])
            if i in self._n_out_replace:
                layer.n_out = self._n_out_replace[i]
                reinit.add(i)
                if i + 1 < keep and hasattr(src.layers[i + 1], "n_in"):
                    reinit.add(i + 1)
            if self._freeze_until is not None and i <= self._freeze_until:
                layer = Frozen(underlying=layer)
            layers.append(layer)
        layers.extend(self._added)

        defaults = (self._fine_tune.apply_to(src.conf.defaults)
                    if self._fine_tune else copy.deepcopy(src.conf.defaults))
        conf = MultiLayerConfiguration(
            defaults=defaults, layers=layers,
            input_type=src.conf.input_type,
            input_preprocessors=dict(src.conf.input_preprocessors),
        )
        new_net = MultiLayerNetwork(conf).init(src.device)
        # copy retained params (skip re-initialized and added layers)
        for i in range(keep):
            k = _key(i)
            if i not in reinit and _same_shapes(src.params[k],
                                                new_net.params[k]):
                new_net.params[k] = tr.clone_tree(src.params[k])
                new_net.state[k] = tr.clone_tree(src.state[k])
        return new_net


class TransferLearningHelper:
    """Featurize through the frozen prefix once, then train only the tail
    (nn/transferlearning/TransferLearningHelper.java)."""

    def __init__(self, net: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        self.net = net
        if frozen_until is None:
            frozen_until = -1
            for i, l in enumerate(net.layers):
                if getattr(l, "frozen", False):
                    frozen_until = i
        self.frozen_until = frozen_until

    def featurize(self, ds: DataSet) -> DataSet:
        """`ds` with its features replaced by the frozen prefix's output
        (train=False), a tensor on the network's device that a later fit
        can differentiate through (no_grad, not inference mode)."""
        import torch

        with torch.no_grad():
            h, _, _ = self.net._walk(self.net.params,
                                     self.net._as_input(ds.features),
                                     to_layer=self.frozen_until + 1)
        return DataSet(h, ds.labels, ds.features_mask, ds.labels_mask)

    def unfrozen_network(self) -> MultiLayerNetwork:
        """A network of only the unfrozen tail, on the source's device,
        holding copies of the tail's params (trained on featurized
        data)."""
        src = self.net
        tail = [copy.deepcopy(l) for l in src.layers[self.frozen_until + 1:]]
        conf = MultiLayerConfiguration(
            defaults=copy.deepcopy(src.conf.defaults), layers=tail,
            input_type=src._input_types[self.frozen_until + 1],
        )
        net = MultiLayerNetwork(conf).init(src.device)
        for j, i in enumerate(range(self.frozen_until + 1, len(src.layers))):
            net.params[_key(j)] = tr.clone_tree(src.params[_key(i)])
        return net

    def fit_featurized(self, featurized, epochs: int = 1):
        """Fit a fresh tail (`unfrozen_network`) on featurized data (a
        DataSet or an iterator of them) and copy its params back."""
        tail = self.unfrozen_network()
        tail.fit(featurized, epochs=epochs)
        for j, i in enumerate(range(self.frozen_until + 1, len(self.net.layers))):
            self.net.params[_key(i)] = tail.params[_key(j)]
        return self.net
