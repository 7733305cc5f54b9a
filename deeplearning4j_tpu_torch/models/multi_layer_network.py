"""MultiLayerNetwork — the sequential-network runtime (counterpart of
deeplearning4j_tpu/models/multi_layer_network.py): inference, stateful RNN
streaming and the training step.

A forward walks the layers eagerly: each layer's input preprocessor, its
`apply` (or, with carries, a recurrent layer's `scan`), then
`propagate_mask` for the next layer. Params and running state are dicts per
layer keyed "layer_{i}", with the JAX package's names (nested where a layer
nests sublayers, as TransformerBlock does), on the device `init` was given.
Inference runs under `torch.inference_mode()`; `rnn_time_step` streams, each
recurrent layer's (h, c) carry kept between calls (rnnTimeStep).

Training (`fit`) is the JAX package's train step, run eagerly: the forward
with `train=True` and the output layer's loss plus the l1/l2 penalty
(`_loss`), `torch.autograd.grad` over the param leaves, then under
`torch.no_grad()` per layer: gradient normalization, the updater rule (at
the learning rate of `lr_schedule` for the iteration), the step and the
constraints (`_apply_updates`; frozen layers skipped). Params are updated
IN PLACE (`p -= step`), so the tensors `init` made stay the network's
params; the updater slots (`opt_state`, one entry per layer with the JAX
names) are replaced each step. `fit` takes a DataSet, features and labels,
or a DataSetIterator; batches already on the network's device are used as
they are. With `backprop_type="tbptt"` a batch whose features and labels
are both [b, t, ...] trains window by window (`_fit_tbptt`, the JAX
package's doTruncatedBPTT): `tbptt_fwd_length` steps per window, each
window one step of the updater whose backward spans the window, the
recurrent carries passed on detached; `score_`, `iteration` and the
listeners advance per window. Any other batch takes the standard step. The
line-search solvers, layerwise `pretrain` and the JAX package's windowed
engine (training/engine.py: step windows, TrainingRun's resume/save
cadence, the stall watchdog, flight bundles, async prefetch) are not ported
yet; `fit` raises on a configuration that needs them.

Dropout and weight noise draw from `draws` (an `nn.dropout.Draws` on the
network's device, seeded from `conf.defaults.seed` by `init`). Each step
(each tBPTT window) takes `draws.step()` and runs under
`iteration_scope(iteration)`, so schedules see the step: layer i of the L
gets `split(L - 1)[i]` for its dropout and, folded with 997, for its weight
noise; the output layer's weight noise folds the step's draws themselves
(not in a tBPTT window), as the JAX package does with its keys. Inference
never draws.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models import _training as tr
from deeplearning4j_tpu_torch.models._training import flat_items  # noqa: F401 (its users import it from here)
from deeplearning4j_tpu_torch.nn import updaters as upd_mod
from deeplearning4j_tpu_torch.nn import weightnoise as wn_mod
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.dropout import Draws
from deeplearning4j_tpu_torch.nn.layers.base import Layer, iteration_scope
from deeplearning4j_tpu_torch.nn.layers.output import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrent

Params = Dict[str, object]


def _key(i: int) -> str:
    return f"layer_{i}"


def warn_bidir_tbptt(bidir: list) -> None:
    """One warning when bidirectional layers (`bidir`: their names) train
    by tBPTT, which the reference refuses
    (GravesBidirectionalLSTM.java:89-93): here, as in the JAX package, the
    backward half restarts at every window, so its gradients see the
    future only up to the window's end. Shared by MultiLayerNetwork and
    ComputationGraph, each of which calls it once."""
    if not bidir:
        return
    warnings.warn(
        f"tBPTT with bidirectional layer(s) {bidir}: the backward scan "
        f"restarts at each chunk boundary, so future context is truncated "
        f"to the tbptt window (the reference rejects this configuration)",
        stacklevel=3)


class MultiLayerNetwork:
    """Construction computes the per-layer input types; `init` allocates
    params (MultiLayerNetwork.init)."""

    def __init__(self, conf: MultiLayerConfiguration):
        conf.validate()
        self.conf = conf
        self.layers: List[Layer] = conf.layers
        self.params: Optional[Dict[str, Params]] = None
        self.state: Optional[Dict[str, Params]] = None
        self.device: Optional[torch.device] = None
        self.opt_state: Optional[list] = None
        self.draws: Optional[Draws] = None
        self.iteration: int = 0
        self.epoch: int = 0
        self.listeners: List = []
        self.score_: float = float("nan")
        self.last_batch_size: int = 0
        self._input_types = conf.layer_input_types()
        self._updaters = self._resolve_updaters()
        self._rnn_carries: Optional[list] = None
        self._checked_bidir_tbptt = False

    def _resolve_updaters(self) -> List[upd_mod.Updater]:
        """Each layer's updater (its own, else the network default), with
        the layer's learning-rate override applied to a copy."""
        return [tr.layer_updater(layer, self.conf.defaults.updater)
                for layer in self.layers]

    def init(self, device=None) -> "MultiLayerNetwork":
        """Random params from `conf.defaults.seed` (one CPU torch.Generator
        drawn layer by layer, so a seed gives the same weights on every
        device), running state at its defaults, zeroed updater slots and
        the dropout draws' generator, all on `device` (default: the CUDA
        card; pass device="cpu" for the CPU)."""
        self.device = device_mod.resolve(device)
        gen = torch.Generator().manual_seed(int(self.conf.defaults.seed))
        self.params, self.state = {}, {}
        for i, layer in enumerate(self.layers):
            in_type = self._input_types[i]
            p = layer.init_params(gen, in_type) if layer.has_params() else {}
            self.params[_key(i)] = tr.to_device(p, self.device)
            self.state[_key(i)] = tr.to_device(layer.init_state(in_type),
                                               self.device)
        self.opt_state = [u.init_state(self.params[_key(i)])
                          for i, u in enumerate(self._updaters)]
        self.draws = Draws.seeded(self.conf.defaults.seed, self.device)
        return self

    def layer(self, key: str) -> Layer:
        """The Layer config under a param key ("layer_3")."""
        return self.layers[int(key.rsplit("_", 1)[1])]

    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params.values()
                       for _, t in flat_items(p)))

    def _as_input(self, x) -> torch.Tensor:
        """x on the network's device in its own dtype: token ids stay
        integers for the embedding's index."""
        if self.params is None:
            raise RuntimeError("call init() before running the network")
        return tr.as_tensor(x).to(self.device)

    def _walk(self, params, x: torch.Tensor, *, train: bool = False,
              mask: Optional[torch.Tensor] = None,
              to_layer: Optional[int] = None, acts: Optional[list] = None,
              carries: Optional[list] = None, rng=None):
        """Forward through layers [0, to_layer) with `params`. Returns (x,
        new_state, mask): the activation, the running state after the walk
        (updated by layers that track statistics when `train`) and the mask
        the next layer would see. Appends each activation to `acts` when
        given. With `carries` (one entry per layer, see `_init_carries`) a
        recurrent layer scans from its entry and the entry is replaced by
        its new carry, in place. With `rng` (a step's draws) and `train`,
        layer i takes `rng.split(to_layer)[i]` for its weight noise and
        dropout."""
        n = len(self.layers) if to_layer is None else to_layer
        rngs = rng.split(n) if rng is not None else [None] * n
        new_state = dict(self.state)
        for i in range(n):
            layer = self.layers[i]
            if i in self.conf.input_preprocessors:
                x = self.conf.input_preprocessors[i].transform(x, mask)
            k = _key(i)
            p = wn_mod.maybe_transform(layer, params[k], rngs[i], train)
            if carries is not None and isinstance(layer, BaseRecurrent):
                x, carries[i] = layer.scan(p, x, carries[i], mask=mask,
                                           train=train, rng=rngs[i])
            else:
                x, st = layer.apply(p, x, state=self.state[k], train=train,
                                    mask=mask, rng=rngs[i])
                if train:
                    new_state[k] = st
            if acts is not None:
                acts.append(x)
            mask = layer.propagate_mask(mask, self._input_types[i])
        return x, new_state, mask

    def _forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 acts: Optional[list] = None,
                 carries: Optional[list] = None) -> torch.Tensor:
        """Inference forward through every layer (see `_walk`)."""
        return self._walk(self.params, x, mask=mask, acts=acts,
                          carries=carries)[0]

    def output(self, x) -> torch.Tensor:
        """Full forward pass (MultiLayerNetwork.output). `x` is an array or
        tensor in the JAX package's layout ([b, t] token ids for a
        TransformerLM), moved to the network's device; returns a tensor on
        that device."""
        with torch.inference_mode():
            return self._forward(self._as_input(x))

    def feed_forward(self, x) -> List[torch.Tensor]:
        """The input and every layer's activation, inference mode, as in
        the JAX package."""
        with torch.inference_mode():
            h = self._as_input(x)
            acts = [h]
            self._forward(h, acts=acts)
        return acts

    # ---- stateful RNN inference (rnnTimeStep) ----
    def _init_carries(self, batch: int, for_streaming: bool = False) -> list:
        """A zero (h, c) carry per recurrent layer, None elsewhere.
        for_streaming (rnn_time_step) rejects a layer that is not
        streamable: a bidirectional layer's backward scan needs the
        sequence end."""
        if for_streaming:
            for l in self.layers:
                if isinstance(l, BaseRecurrent) and not l.streamable:
                    raise ValueError(
                        f"{type(l).__name__} is bidirectional: rnnTimeStep "
                        f"needs a forward-only state carry (backward scan "
                        f"requires the sequence end)")
        return [l.init_carry(batch, self.device)
                if isinstance(l, BaseRecurrent) else None
                for l in self.layers]

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed one or more timesteps, carrying every recurrent layer's
        state across calls. x: [b, t, f], or [b, f] for a single step (then
        the result is [b, n_out]). Returns a tensor on the network's
        device."""
        with torch.inference_mode():
            x = self._as_input(x)
            single = x.dim() == 2
            if single:
                x = x[:, None, :]
            carries = self._rnn_carries
            if carries is None:
                carries = self._init_carries(x.shape[0], for_streaming=True)
            carries = list(carries)  # a failed call keeps the old state
            h = self._forward(x, carries=carries)
            self._rnn_carries = carries
        return h[:, 0] if single and h.dim() == 3 else h

    # ---- training (the JAX package's train step, eagerly) ----
    def _reg_score(self, params) -> torch.Tensor:
        """The l1/l2 penalty over all layers (BaseLayer.calcL1/calcL2):
        l1 * sum|w| + 0.5 * l2 * sum w^2 over each layer's `regularizable`
        params, and the bias terms over its params named "b*"."""
        total = torch.zeros((), device=self.device)
        for i, layer in enumerate(self.layers):
            p = params[_key(i)]
            if p:
                total = tr.layer_penalty(layer, p, self.conf.defaults,
                                         biases=True, total=total)
        return total

    def _loss(self, params, x, y, fmask=None, lmask=None, train=True,
              carries=None, rng=None):
        """(score, new_state): the output layer's loss on the last hidden
        activation, under the labels mask (else the propagated features
        mask), plus the l1/l2 penalty. With `carries` the recurrent layers
        scan from them and leave their new carries there (see `_walk`).
        `rng` is the step's draws; the output layer's weight noise takes
        them folded, except in a tBPTT window (with `carries`), where the
        JAX package applies none."""
        out_layer = self.layers[-1]
        if not isinstance(out_layer, BaseOutputLayer):
            raise TypeError("the last layer must be an output layer "
                            "(Output, RnnOutput, LossLayer)")
        n = len(self.layers)
        h, new_state, cur_mask = self._walk(params, x, train=train,
                                            mask=fmask, to_layer=n - 1,
                                            carries=carries, rng=rng)
        k = _key(n - 1)
        p_out = params[k]
        if carries is None:
            p_out = wn_mod.maybe_transform(out_layer, p_out, rng, train)
        score, _, out_state = out_layer.compute_loss(
            p_out, h, y, state=self.state[k],
            mask=lmask if lmask is not None else cur_mask)
        new_state[k] = out_state
        return score + self._reg_score(params), new_state

    def _apply_updates(self, grads, iteration: int) -> None:
        """Per layer, in place: gradient normalization, the updater rule at
        the scheduled learning rate, params -= step, constraints
        (`_training.update_layer`). Frozen layers and layers without params
        are left alone."""
        for i, layer in enumerate(self.layers):
            k = _key(i)
            g = grads.get(k)
            if not g or getattr(layer, "frozen", False):
                continue
            self.opt_state[i] = tr.update_layer(
                layer, self.conf.defaults, self._updaters[i], self.params[k],
                g, self.opt_state[i], iteration)

    def _check_trainable(self) -> None:
        tr.check_trainable(self.conf.defaults)

    def _batch(self, a):
        """A batch array as a tensor on the network's device: a tensor
        already there is used as it is (no copy)."""
        return None if a is None else tr.as_tensor(a).to(self.device)

    def _step(self, x, y, fm, lm, carries=None) -> None:
        """One updater step on one batch (or tBPTT window): loss, gradients,
        updates, then `score_`, `last_batch_size`, `iteration` and the
        listeners. With `carries` the recurrent layers start from them and
        leave their new carries there, detached. Dropout and weight noise
        draw from `draws.step()`, schedules at the step's iteration."""
        rng = self.draws.step()
        with iteration_scope(self.iteration):
            score, new_state, grads = tr.value_and_grad(
                lambda: self._loss(self.params, x, y, fm, lm,
                                   carries=carries, rng=rng),
                self.params)
        if carries is not None:
            carries[:] = [tr.detach_carry(c) for c in carries]
        with torch.no_grad():
            self._apply_updates(grads, self.iteration)
            self.state = {k: tr.detach(v) for k, v in new_state.items()}
        self.score_ = float(score.detach())
        self.last_batch_size = tr.batch_rows(x)
        self.iteration += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.score_)

    def _fit_batch(self, ds: DataSet) -> None:
        """One updater step on `ds`, or one per window when it trains by
        tBPTT (`_tbptt_batch`)."""
        batch = [self._batch(a) for a in (ds.features, ds.labels,
                                          ds.features_mask, ds.labels_mask)]
        if self._tbptt_batch(ds):
            self._fit_tbptt(*batch)
        else:
            self._step(*batch)

    def _tbptt_batch(self, ds: DataSet) -> bool:
        """Whether `ds` trains by tBPTT: the configuration asks for it and
        features and labels both have a time axis (per-sequence labels
        cannot be cut into windows; the JAX package's `tbptt_batch`)."""
        return (self.conf.defaults.backprop_type == "tbptt"
                and ds.features.ndim == 3 and ds.labels.ndim == 3)

    def _fit_tbptt(self, x, y, fm, lm) -> None:
        """Truncated BPTT (MultiLayerNetwork.doTruncatedBPTT, the JAX
        package's `_fit_tbptt`): windows of `tbptt_fwd_length` steps, each
        one updater step; the recurrent carries start at zero and pass from
        window to window detached (a bidirectional layer's backward half
        restarts in every window, with one warning per network). The
        backward spans the whole window (the JAX package reads only
        `tbptt_fwd_length`)."""
        if not self._checked_bidir_tbptt:
            warn_bidir_tbptt([type(l).__name__ for l in self.layers
                              if isinstance(l, BaseRecurrent)
                              and not l.streamable])
            self._checked_bidir_tbptt = True
        T, L = x.shape[1], self.conf.defaults.tbptt_fwd_length
        carries = self._init_carries(x.shape[0])

        def window(a, sl):
            return None if a is None else a[:, sl].contiguous()

        for t0 in range(0, T, L):
            sl = slice(t0, min(t0 + L, T))
            self._step(window(x, sl), window(y, sl), window(fm, sl),
                       window(lm, sl), carries=carries)

    def _as_iterator(self, data, labels=None) -> DataSetIterator:
        if isinstance(data, DataSetIterator):
            return data
        if isinstance(data, DataSet):
            return ListDataSetIterator(data, batch=data.num_examples())
        if labels is not None:
            ds = DataSet(data, labels)
            return ListDataSetIterator(ds, batch=ds.num_examples())
        raise TypeError(f"Cannot build iterator from {type(data)}")

    def fit(self, data, labels=None, epochs: int = 1) -> "MultiLayerNetwork":
        """fit(DataSetIterator) | fit(DataSet) | fit(features, labels): one
        training step per batch, `epochs` passes (MultiLayerNetwork.fit).
        After each step (each tBPTT window) `score_` holds its loss (with
        the l1/l2 penalty), `last_batch_size` its rows, and every listener's
        `iteration_done(net, iteration, score)` has run."""
        if self.params is None:
            raise RuntimeError("call init() before fit()")
        self._check_trainable()
        iterator = self._as_iterator(data, labels)
        for _ in range(epochs):
            for ds in iterator:
                self._fit_batch(ds)
            self.epoch += 1
        return self

    def score(self, ds: DataSet, training: bool = False) -> float:
        """The loss on a dataset (score(DataSet)), penalty included. With
        `training`, dropout and weight noise draw from a generator seeded
        with 0 (the JAX package's fixed PRNGKey(0)), not from `draws`."""
        rng = Draws.seeded(0, self.device) if training else None
        with torch.no_grad():
            s, _ = self._loss(self.params, self._batch(ds.features),
                              self._batch(ds.labels),
                              self._batch(ds.features_mask),
                              self._batch(ds.labels_mask), train=training,
                              rng=rng)
        return float(s)

    def set_listeners(self, *listeners) -> "MultiLayerNetwork":
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners) -> "MultiLayerNetwork":
        self.listeners.extend(listeners)
        return self

    def get_param_table(self) -> Dict[str, np.ndarray]:
        """"layer_i/name" -> numpy array (paramTable()), nested params
        flattened with '/' ("layer_2/attn/Wqkv"). The JAX package's table
        keeps a nested dict as ONE entry ("layer_2/attn" -> a 0-d numpy
        object array holding the dict); flattening that dict the same way
        gives exactly this table."""
        flat = {}
        for i, layer in enumerate(self.layers):
            for path, t in flat_items(self.params[_key(i)]):
                t = layer.to_interchange(path, t)
                # a copy: fit updates the params in place
                flat[f"{_key(i)}/{path}"] = t.detach().to(
                    "cpu", copy=True).numpy()
        return flat
