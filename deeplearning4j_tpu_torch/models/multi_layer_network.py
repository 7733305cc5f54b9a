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
listeners advance per window. Any other batch takes the standard step.
`fit` itself is the JAX package's thin facade over `training.engine.
TrainingRun` (the listeners' lifecycle events, `checkpoint_manager=`
resume and epoch-end saves, `epochs` the total target); an iterator is
wrapped in `AsyncDataSetIterator` where it allows it. A frozen layer
(`nn.layers.misc.Frozen`) takes no update, and its params are no leaves of
the gradient, so the backward ends at the first trainable layer.

Each layer runs under its `remat` policy at train time
(`parallel.layout.maybe_remat`: no checkpoint, the whole layer recomputed
in the backward, products and convolutions saved, or the saved
activations in host memory; a recompute replays the forward's draws).
Under ParallelWrapper's fsdp or model axis the params live sharded
(`_shard_layout`, a `parallel.layout.FsdpArrangement`): each layer's are
gathered on use inside its remat scope (`parallel.layout.apply_layer`, the
one seam of both), so the backward gathers again,
and a layer that computes on its model shards runs inside
`nn.shard.splitting`; `get_param_table`, saves and checkpoints give the
whole params (collectively).

A step is split as the JAX package's is: `_device_step` (loss, gradients,
updates, running state; the score stays a 0-d device tensor) and
`_bookkeep` (`score_`, `last_batch_size`, `iteration`, the listeners), so
the engine's step windows (`DL4J_TPU_STEP_WINDOW`) run K device steps with
one host read. A line-search `optimization_algo` (conjugate_gradient,
lbfgs, line_gradient_descent) takes one solver iteration per batch that
does not train by tBPTT (`_fit_batch_solver`, `optimize.solvers`); tBPTT
batches and ParallelWrapper take the SGD updater step with the JAX
package's warning, once per network.

Layerwise pretraining (`pretrain`, `pretrain_layer`; the JAX package's
greedy layer-by-layer pass) trains each layer that has a `pretrain_loss`
(AutoEncoder, RBM, VariationalAutoencoder) on the inference-mode
activations of the layers below it: a fresh slot state from the layer's
own updater, one draw of `draws.step()` per batch, the raw updater step at
the updater's learning rate (no l1/l2, no gradient normalization, no
iteration count, as there), `score_` read per batch.

Evaluation (`evaluate`, `evaluate_regression`, `evaluate_roc`,
`evaluate_roc_multi_class`, `evaluate_calibration`) runs `output` on the
device and the evaluators on the host (`eval.eval_over`); `predict` gives
the argmax class ids as numpy. `summary`, `clone` and `set_param_table`
are the JAX package's.

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

import functools
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
    prefetching,
)
from deeplearning4j_tpu_torch.models import _training as tr
from deeplearning4j_tpu_torch.models._training import flat_items  # noqa: F401 (its users import it from here)
from deeplearning4j_tpu_torch.nn import updaters as upd_mod
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.dropout import Draws
from deeplearning4j_tpu_torch.nn.layers.base import Layer, iteration_scope
from deeplearning4j_tpu_torch.nn.layers.output import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrent
from deeplearning4j_tpu_torch.nn.regularization import apply_constraints

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

    #: where the params live sharded, a `parallel.layout.FsdpArrangement`
    #: (ParallelWrapper's fsdp or model axis), else None
    _shard_layout = None

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
        self._solver = None  # the line-search solver, built at first use
        self._warned_sgd_fallback = False
        self._window_replay = False  # set by a step window's replay

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

    def summary(self) -> str:
        """The layer table (MultiLayerNetwork.summary()): the JAX package's
        columns, names, shapes and parameter counts."""
        lines = ["=" * 70]
        lines.append(f"{'idx':<4}{'layer':<28}{'in -> out':<26}{'params':>10}")
        lines.append("-" * 70)
        types = self._input_types
        for i, l in enumerate(self.layers):
            n = (sum(t.numel() for _, t in flat_items(self.params[_key(i)]))
                 if self.params else 0)
            shapes = f"{types[i].shape()}->{types[i + 1].shape()}"
            lines.append(f"{i:<4}{type(l).__name__:<28}{shapes:<26}{n:>10}")
        lines.append("-" * 70)
        lines.append(f"total params: {self.num_params() if self.params else 0}")
        lines.append("=" * 70)
        return "\n".join(lines)

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
        from deeplearning4j_tpu_torch.parallel import layout as layout_mod

        n = len(self.layers) if to_layer is None else to_layer
        rngs = rng.split(n) if rng is not None else [None] * n
        new_state = dict(self.state)
        # params sharded at rest (ParallelWrapper's fsdp or model axis):
        # each layer's are gathered right before use, inside its remat
        # scope, so a remat policy's backward gathers again
        arr = self._shard_layout
        for i in range(n):
            layer = self.layers[i]
            if i in self.conf.input_preprocessors:
                x = self.conf.input_preprocessors[i].transform(x, mask)
            k = _key(i)
            if carries is not None and isinstance(layer, BaseRecurrent):
                x, carries[i] = layout_mod.apply_layer(
                    arr, k, layer, params[k],
                    functools.partial(tr.layer_scan, layer, train), x,
                    carries[i], mask, rng=rngs[i])
            else:
                x, st = layout_mod.apply_layer(
                    arr, k, layer, params[k],
                    functools.partial(tr.layer_forward, layer,
                                      self.state[k], train), x, mask,
                    remat=layer.remat if train else None, rng=rngs[i])
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
                                         biases=True, total=total,
                                         key=_key(i),
                                         arr=self._shard_layout)
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
        from deeplearning4j_tpu_torch.parallel import layout as layout_mod

        k = _key(n - 1)
        wn_rng = rng if carries is None else None
        score, _, out_state = layout_mod.apply_layer(
            self._shard_layout, k, out_layer, params[k],
            functools.partial(tr.layer_loss, out_layer, self.state[k],
                              train),
            h, y, lmask if lmask is not None else cur_mask, rng=wn_rng)
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
                g, self.opt_state[i], iteration, key=k,
                arr=self._shard_layout)

    def _frozen_keys(self) -> frozenset:
        """The param keys of frozen layers: no leaves of the gradient."""
        return frozenset(_key(i) for i, l in enumerate(self.layers)
                         if getattr(l, "frozen", False))

    def _batch(self, a):
        """A batch array as a tensor on the network's device: a tensor
        already there is used as it is (no copy)."""
        return None if a is None else tr.as_tensor(a).to(self.device)

    def _device_step(self, x, y, fm, lm, carries=None,
                     iteration: Optional[int] = None) -> torch.Tensor:
        """The device half of one updater step: loss, gradients, updates
        and running state, with no host read. Returns the score as a 0-d
        tensor on the device. `iteration` (default `self.iteration`) is
        the step's for the schedules and `iteration_scope`; a step window
        passes it0 + j. With `carries` the recurrent layers start from
        them and leave their new carries there, detached. Dropout and
        weight noise draw from `draws.step()`."""
        it = self.iteration if iteration is None else iteration
        rng = tr.step_draws(self.draws.step())
        with iteration_scope(it):
            score, new_state, grads = tr.value_and_grad(
                lambda: self._loss(self.params, x, y, fm, lm,
                                   carries=carries, rng=rng),
                self.params, frozen=self._frozen_keys())
        if carries is not None:
            carries[:] = [tr.detach_carry(c) for c in carries]
        with torch.no_grad():
            self._apply_updates(grads, it)
            self.state = {k: tr.detach(v) for k, v in new_state.items()}
        return score.detach()

    def _bookkeep(self, score: float, rows: int) -> None:
        """The host half of a step: `score_`, `last_batch_size`,
        `iteration` and the listeners."""
        self.score_ = score
        self.last_batch_size = rows
        self.iteration += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.score_)

    def _step(self, x, y, fm, lm, carries=None) -> None:
        """One updater step on one batch (or tBPTT window): the device
        step, one host read of its score, the bookkeeping."""
        score = self._device_step(x, y, fm, lm, carries)
        self._bookkeep(float(score), tr.batch_rows(x))

    def _uses_solver(self) -> bool:
        return self.conf.defaults.optimization_algo not in (
            "stochastic_gradient_descent", "sgd")

    def _fit_batch(self, ds: DataSet, solver: bool = True) -> None:
        """One step on `ds`: per window when it trains by tBPTT
        (`_tbptt_batch`), one solver iteration when the configuration
        names a line-search solver (and `solver`; ParallelWrapper passes
        False and takes the SGD step, as the JAX package's does), else
        one updater step."""
        batch = [self._batch(a) for a in (ds.features, ds.labels,
                                          ds.features_mask, ds.labels_mask)]
        if self._tbptt_batch(ds):
            self._fit_tbptt(*batch)
        elif solver and self._uses_solver():
            self._fit_batch_solver(*batch)
        else:
            self._step(*batch)

    def _warn_sgd_fallback(self) -> None:
        """The JAX package's warning, once per network, where a path takes
        the SGD updater step although the configuration names a
        line-search solver (tBPTT, ParallelWrapper)."""
        if self._uses_solver() and not self._warned_sgd_fallback:
            self._warned_sgd_fallback = True
            warnings.warn(
                f"optimization_algo={self.conf.defaults.optimization_algo!r}"
                " is only honored by MultiLayerNetwork.fit on 2D batches; "
                "this path (tBPTT / ParallelWrapper / prebuilt train step) "
                "uses the SGD updater step instead.", stacklevel=3)

    def _fit_batch_solver(self, x, y, fm, lm) -> None:
        """One iteration of the line-search solver named by
        `optimization_algo` (Solver.java: ConjugateGradient, LBFGS,
        LineGradientDescent; the JAX package's `_fit_batch_solver`). The
        solver's curvature state persists across batches. Frozen layers
        are left out of the optimized vector; per-layer gradient
        normalization applies inside the value-and-gradient; after the
        step the new params are copied into the live tensors, constraints
        apply, and one more training forward at the new params refreshes
        the running state (BatchNorm) where there is any. Every
        evaluation of the iteration sees the same dropout masks and weight
        noise (`nn.dropout.repeatable`), as the JAX package's one key."""
        from deeplearning4j_tpu_torch.nn.dropout import repeatable

        draws = repeatable(self.draws.step())
        frozen = self._frozen_keys()
        if self._solver is None:
            self._solver = self._build_solver()
        train_p = {k: v for k, v in self.params.items() if k not in frozen}
        frozen_p = {k: v for k, v in self.params.items() if k in frozen}
        for p in frozen_p.values():
            for _, t in flat_items(p):
                t.requires_grad_(False)
        new_p, score = self._solver.optimize(train_p, frozen_p, x, y, fm,
                                             lm, draws)
        with torch.no_grad():
            for k, p in new_p.items():
                upd_mod.tree_map(lambda live, new: live.copy_(new),
                                 self.params[k], p)
                layer = self.layer(k)
                if layer.constraints:
                    upd_mod.tree_map(
                        lambda live, c: live.copy_(c), self.params[k],
                        apply_constraints(self.params[k], layer.constraints))
            if any(self.state.values()):
                _, new_state = self._loss(self.params, x, y, fm, lm,
                                          train=True, rng=draws())
                self.state = {k: tr.detach(v) for k, v in new_state.items()}
        self._bookkeep(float(score), tr.batch_rows(x))

    def _build_solver(self):
        """The Solver of `optimization_algo` over the trainable params:
        its value-and-gradient applies each layer's gradient
        normalization, its line-search trials score under no_grad."""
        from deeplearning4j_tpu_torch.optimize import solvers

        d = self.conf.defaults

        def loss(tp, fp, x, y, fm, lm, draws):
            return self._loss({**fp, **tp}, x, y, fm, lm, train=True,
                              rng=draws())

        def value_and_grad(tp, fp, x, y, fm, lm, draws):
            score, _, grads = tr.value_and_grad(
                lambda: loss(tp, fp, x, y, fm, lm, draws), tp)
            normed = {}
            for k, g in grads.items():
                layer = self.layer(k)
                gn = (layer.gradient_normalization
                      if layer.gradient_normalization is not None
                      else d.gradient_normalization)
                thr = (layer.gradient_normalization_threshold
                       if layer.gradient_normalization_threshold is not None
                       else d.gradient_normalization_threshold)
                normed[k] = upd_mod.normalize_gradients(g, gn, thr)
            return score, normed

        lr = (d.updater.learning_rate if d.learning_rate is None
              else d.learning_rate)
        return solvers.Solver(
            d.optimization_algo, value_and_grad, learning_rate=lr,
            max_line_search_iterations=d.max_num_line_search_iterations,
            score_fn=lambda *a: loss(*a)[0])

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

    def _engine_loop(self):
        """This network's wiring of `training.engine.WindowedFitLoop`:
        `stage` moves a batch to the device for a step window (None for a
        tBPTT or solver batch, which runs through `_fit_batch` after the
        pending window), the device step is `_device_step`."""
        from deeplearning4j_tpu_torch.training.engine import WindowedFitLoop

        def stage(ds):
            if self._tbptt_batch(ds) or self._uses_solver():
                return None
            batch = tuple(self._batch(a) for a in (
                ds.features, ds.labels, ds.features_mask, ds.labels_mask))
            return batch, int(batch[0].shape[0])

        return WindowedFitLoop(self, raw_step=self._device_step, stage=stage,
                               exec_one=self._fit_batch)

    def _as_iterator(self, data, labels=None) -> DataSetIterator:
        """An iterator over `data`: a DataSetIterator wrapped in
        AsyncDataSetIterator where it allows it (the JAX package's
        `_as_iterator`; its producer copies each batch to the card when
        `DL4J_TPU_DEVICE_PREFETCH` is on), a DataSet or (features, labels)
        as one batch."""
        if isinstance(data, DataSetIterator):
            from deeplearning4j_tpu_torch.training.engine import (
                device_prefetch_place,
            )

            return prefetching(data, place=device_prefetch_place(
                self.device))
        if isinstance(data, DataSet):
            return ListDataSetIterator(data, batch=data.num_examples())
        if labels is not None:
            ds = DataSet(data, labels)
            return ListDataSetIterator(ds, batch=ds.num_examples())
        raise TypeError(f"Cannot build iterator from {type(data)}")

    def fit(self, data, labels=None, epochs: int = 1,
            **attachments) -> "MultiLayerNetwork":
        """fit(DataSetIterator) | fit(DataSet) | fit(features, labels): one
        training step per batch (per tBPTT window), `epochs` passes
        (MultiLayerNetwork.fit), through `training.engine.TrainingRun`:
        `checkpoint_manager=` resumes from its newest checkpoint first
        (`epochs` is the total target) and saves at each epoch end; the
        listeners see on_fit_start, on_epoch_start / on_epoch_end and
        on_fit_end around the steps. After each step `score_` holds its
        loss (with the l1/l2 penalty), `last_batch_size` its rows, and
        every listener's `iteration_done(net, iteration, score)` has
        run. `DL4J_TPU_STEP_WINDOW` > 1 runs the standard steps in
        windows of that many with one host read each (`training.engine.
        WindowedFitLoop`); a line-search `optimization_algo` takes one
        solver iteration per batch that is not trained by tBPTT."""
        from deeplearning4j_tpu_torch.training.engine import TrainingRun

        if self.params is None:
            raise RuntimeError("call init() before fit()")
        run = TrainingRun(self, epochs=epochs, **attachments)
        if self.conf.defaults.backprop_type == "tbptt":
            self._warn_sgd_fallback()
        iterator = self._as_iterator(data, labels)
        # a prefetch producer started here is stopped here
        return run.execute(
            self._engine_loop().run_epoch, iterator,
            cleanup=(getattr(iterator, "shutdown", None)
                     if iterator is not data else None))

    # ---- layerwise pretraining (MultiLayerNetwork.pretrain /
    # pretrainLayer) ----
    def pretrain(self, iterator, epochs: int = 1) -> "MultiLayerNetwork":
        """Greedy layerwise unsupervised pretraining: every layer with a
        `pretrain_loss` (AutoEncoder, RBM, VariationalAutoencoder) is
        trained in turn on the activations of the layers below it."""
        for i, layer in enumerate(self.layers):
            if hasattr(layer, "pretrain_loss"):
                self.pretrain_layer(i, iterator, epochs=epochs)
        return self

    def pretrain_layer(self, layer_idx: int, iterator,
                       epochs: int = 1) -> "MultiLayerNetwork":
        """`epochs` passes over `iterator` minimizing layer `layer_idx`'s
        `pretrain_loss`, as the JAX package does: a fresh slot state from
        the layer's updater; per batch the activations below the layer in
        inference mode (without the layer's own preprocessor), one
        `draws.step()` for the loss's draws, the gradient of the loss, the
        updater's raw step at its learning rate (no l1/l2, gradient
        normalization or iteration), params updated in place, `score_`
        the batch's loss. Raises ValueError for a layer without an
        objective."""
        layer = self.layers[layer_idx]
        if not hasattr(layer, "pretrain_loss"):
            raise ValueError(f"layer {layer_idx} has no pretrain objective")
        if self.params is None:
            raise RuntimeError("call init() before pretrain()")
        k = _key(layer_idx)
        u = self._updaters[layer_idx]
        p = self.params[k]
        opt = u.init_state(p)
        it_ = self._as_iterator(iterator, None)
        try:
            for _ in range(epochs):
                for ds in it_:
                    rng = self.draws.step()
                    with torch.no_grad():
                        h = self._walk(self.params, self._batch(ds.features),
                                       to_layer=layer_idx)[0]
                    score, _, grads = tr.value_and_grad(
                        lambda: (layer.pretrain_loss(p, h, rng), None),
                        {k: p})
                    with torch.no_grad():
                        steps, opt = u.apply(grads[k], opt, u.learning_rate)
                        upd_mod.tree_map(lambda a, s: a.sub_(s), p, steps)
                    self.score_ = float(score.detach())
        finally:
            if it_ is not iterator and hasattr(it_, "shutdown"):
                it_.shutdown()
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

    # ---- evaluation (the JAX package's evaluate* family) ----
    def predict(self, x) -> np.ndarray:
        """Argmax class ids of `output` as numpy (predict)."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def evaluate(self, iterator, metric: str = "classification"):
        """Classification evaluation over an iterator (evaluate)."""
        from deeplearning4j_tpu_torch.eval import Evaluation, eval_over

        return eval_over(self.output, iterator, Evaluation())

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.eval import (
            RegressionEvaluation,
            eval_over,
        )

        return eval_over(self.output, iterator, RegressionEvaluation())

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        from deeplearning4j_tpu_torch.eval import ROC, eval_over

        return eval_over(self.output, iterator, ROC(threshold_steps))

    def evaluate_roc_multi_class(self, iterator, threshold_steps: int = 0):
        """One-vs-all ROC per class (evaluateROCMultiClass)."""
        from deeplearning4j_tpu_torch.eval import ROCMultiClass, eval_over

        return eval_over(self.output, iterator,
                         ROCMultiClass(threshold_steps))

    def evaluate_calibration(self, iterator, reliability_bins: int = 10,
                             histogram_bins: int = 50):
        """Reliability diagrams and probability histograms (doEvaluation
        with EvaluationCalibration)."""
        from deeplearning4j_tpu_torch.eval import (
            EvaluationCalibration,
            eval_over,
        )

        return eval_over(self.output, iterator,
                         EvaluationCalibration(reliability_bins,
                                               histogram_bins))

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
            for path, t in flat_items(tr.whole_params(self, _key(i))):
                t = layer.to_interchange(path, t)
                # a copy: fit updates the params in place
                flat[f"{_key(i)}/{path}"] = t.detach().to(
                    "cpu", copy=True).numpy()
        return flat

    def set_param_table(self, table: Dict[str, np.ndarray]) -> None:
        """Load "layer_i/name" arrays in the interchange layout (the
        inverse of `get_param_table`; setParamTable), each onto the
        network's device in its layer's layout, nested names by '/'. The
        arrays are whole; a sharded network keeps this rank's slices."""
        arr = self._shard_layout
        for full, v in table.items():
            k, path = full.split("/", 1)
            layer = self.layer(k)
            t = layer.from_interchange(path, tr.as_tensor(np.asarray(
                v, np.float32))).to(self.device)
            if arr is not None:
                t = arr.placement(k, path).local(t, arr.mesh)
            node = self.params[k]
            *parents, name = path.split("/")
            for part in parents:
                node = node[part]
            node[name] = t

    def clone(self) -> "MultiLayerNetwork":
        """An independent copy on the same device (clone): the
        configuration through its JSON, every param, running state and
        updater slot copied (whole, from a sharded network), the counters
        and the dropout generator's state carried."""
        other = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()))
        other.init(self.device)
        # whole params and slots: a sharded network's are gathered
        other.params = tr.clone_tree({k: tr.whole_params(self, k)
                                      for k in self.params})
        other.state = tr.clone_tree(self.state)
        other.opt_state = tr.clone_tree(
            [tr.whole_slots(self, k, s)
             for k, s in zip(self.params, self.opt_state)])
        other.iteration, other.epoch = self.iteration, self.epoch
        gen = getattr(self.draws, "generator", None)
        if gen is not None:
            other.draws.generator.set_state(gen.get_state())
        return other
