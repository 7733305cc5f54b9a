"""ComputationGraph — DAG network runtime: inference, stateful RNN
streaming and the training step, with time masks and truncated BPTT
(counterpart of deeplearning4j_tpu/models/computation_graph.py).

The topological order is computed once from the config; a forward walks it
eagerly, vertex by vertex. Params and running state are plain dicts of
tensors per vertex name, with the JAX package's names, on the device `init`
was given. Inference runs under `torch.inference_mode()`; `rnn_time_step`
streams through the DAG: each recurrent vertex's (h, c) carry is kept
between calls (ComputationGraph.rnnTimeStep).

Training (`fit`) is the JAX package's train step, run eagerly: the forward
with `train=True` up to the output vertices, each of which hands its input
to its layer's loss; the sum of the losses plus the l1/l2 penalty
(`_loss`); `torch.autograd.grad` over the param leaves; then under
`torch.no_grad()` per vertex: gradient normalization, the updater rule at
the scheduled learning rate, the step and the constraints
(`_apply_updates`). Params are updated IN PLACE (`p -= step`), so the
tensors `init` made stay the network's params; the updater slots
(`opt_state`, one entry per vertex with the JAX names) and the running
state (BatchNorm's EMA) are replaced each step. `fit` takes a MultiDataSet,
a DataSet, a DataSetIterator, or features and labels (lists for several
inputs or outputs); batches already on the network's device are used as
they are. `fit` is the JAX package's thin facade over `training.engine.
TrainingRun` (the listeners' lifecycle events, `checkpoint_manager=`
resume and epoch-end saves, `epochs` the total target); an iterator is
wrapped in `AsyncDataSetIterator` for each epoch where it allows it. A
Frozen layer in a graph runs with train=False but is updated, as in the
JAX package (whose graph step has no frozen check; ROADMAP C.11). As in
the JAX package, a line-search `optimization_algo` trains with the SGD
updater step here (its graph has no solver path). A step is split into
`_device_step` and `_bookkeep`, so the engine's step windows
(`DL4J_TPU_STEP_WINDOW`) run K device steps with one host read; tBPTT
batches run their windows per step. Each LayerVertex runs under its
layer's `remat` policy (`parallel.layout.maybe_remat`) at train time, and
under ParallelWrapper's fsdp or model axis its params, sharded at rest
(`_shard_layout`), are gathered on use inside that scope
(`parallel.layout.apply_layer`), so a policy's backward gathers again;
`get_param_table` gives them whole.

Evaluation: `do_evaluation` feeds one pass of a single-output graph to
several evaluators, `evaluate_outputs` each output of a multi-output graph
to its own, and the `evaluate*` family wraps `do_evaluation`; `output`
runs on the device, the evaluators on the host (`eval.host`). `summary`
prints the JAX package's table.

Masks: each network input takes its features mask, each vertex gets its
inputs' masks (a LayerVertex hands the first to its layer) and gives its
output the mask of its `propagate_mask`; an output vertex's loss takes its
labels mask, else the mask that reached its input. With
`backprop_type="tbptt"` a batch whose first features and every label are
[b, t, ...] trains window by window (`_fit_tbptt`, the JAX package's
`_tbptt_mds` predicate): `tbptt_fwd_length` steps per window, the masks
sliced with it, each window one updater step whose backward spans it, the
recurrent vertices' carries passed on detached (a bidirectional layer's
backward half restarts in every window, with one warning per network); a
batch with 2-D labels trains by whole-sequence BPTT.

Dropout and weight noise draw from `draws` (an `nn.dropout.Draws` on the
network's device, seeded from `conf.defaults.seed` by `init`): each step
takes `draws.step()` under `iteration_scope(iteration)`; the vertex at
position i of the topological order gets `split(len(topo))[i]` (a
LayerVertex applies its layer's weight noise with it, folded with 997, and
the layer's dropout), and an output vertex's weight noise folds the step's
draws themselves, as the JAX package does with its keys.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    prefetching,
)
from deeplearning4j_tpu_torch.models import _training as tr
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    warn_bidir_tbptt,
)
from deeplearning4j_tpu_torch.nn.dropout import Draws
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import LayerVertex
from deeplearning4j_tpu_torch.nn.layers.base import iteration_scope
from deeplearning4j_tpu_torch.nn.layers.output import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrent,
    LastTimeStep,
)

Params = Dict[str, torch.Tensor]


def _vertex_forward(vertex, state, train, p, xs, masks, rng=None):
    """One vertex's forward on `p` (for `parallel.layout.apply_layer`)."""
    return vertex.apply(p, xs, state=state, train=train, masks=masks,
                        rng=rng)


class ComputationGraph:
    #: where the params live sharded, a `parallel.layout.FsdpArrangement`
    #: (ParallelWrapper's fsdp or model axis), else None
    _shard_layout = None

    def __init__(self, conf: ComputationGraphConfiguration):
        conf.validate()
        self.conf = conf
        self.topo = conf.topological_order()
        self.vertex_types = conf.vertex_output_types()
        self.params: Optional[Dict[str, Params]] = None
        self.state: Optional[Dict[str, Params]] = None
        self.device: Optional[torch.device] = None
        self.opt_state: Optional[Dict[str, object]] = None
        self.draws: Optional[Draws] = None
        self.iteration: int = 0
        self.epoch: int = 0
        self.listeners: List = []
        self.score_: float = float("nan")
        self.last_batch_size: int = 0
        self._vin_types = {name: self._in_types(name) for name in self.topo}
        self._updaters = {name: tr.layer_updater(self.layer(name),
                                                 conf.defaults.updater)
                          for name in self.topo}
        self._rnn_carries: Optional[Dict[str, tuple]] = None
        self._checked_bidir_tbptt = False
        self._window_replay = False  # set by a step window's replay

    def _in_types(self, name):
        types = dict(zip(self.conf.network_inputs, self.conf.input_types))
        types.update(self.vertex_types)
        return [types[i] for i in self.conf.vertex_inputs[name]]

    def init(self, device=None) -> "ComputationGraph":
        """Random params from `conf.defaults.seed` (one CPU torch.Generator
        drawn in topological order, so a seed gives the same weights on
        every device), running state at its defaults, zeroed updater slots
        and the dropout draws' generator, all on `device` (default: the
        CUDA card; pass device="cpu" for the CPU)."""
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
        self.opt_state = {name: self._updaters[name].init_state(
            self.params[name]) for name in self.topo}
        self.draws = Draws.seeded(self.conf.defaults.seed, self.device)
        return self

    def layer(self, name: str):
        """The Layer config of a LayerVertex (None for other vertices)."""
        v = self.conf.vertices[name]
        return v.layer if isinstance(v, LayerVertex) else None

    def num_params(self) -> int:
        return int(sum(t.numel() for p in self.params.values()
                       for t in p.values()))

    def summary(self) -> str:
        """The vertex table (ComputationGraph.summary()): the JAX package's
        columns, names, shapes and parameter counts."""
        lines = ["=" * 78]
        lines.append(f"{'vertex':<22}{'type':<24}{'out shape':<20}"
                     f"{'params':>10}")
        lines.append("-" * 78)
        for name in self.conf.network_inputs:
            t = self.vertex_types.get(name)
            shape = str(t.shape()) if t is not None else ""
            lines.append(f"{name:<22}{'Input':<24}{shape:<20}{0:>10}")
        for name in self.topo:
            v = self.conf.vertices[name]
            kind = (type(v.layer).__name__
                    if isinstance(v, LayerVertex) else type(v).__name__)
            t = self.vertex_types.get(name)
            shape = str(t.shape()) if t is not None else ""
            n = (sum(x.numel() for x in self.params[name].values())
                 if self.params else 0)
            lines.append(f"{name:<22}{kind:<24}{shape:<20}{n:>10}")
        lines.append("-" * 78)
        lines.append(f"total params: {self.num_params() if self.params else 0}")
        lines.append("=" * 78)
        return "\n".join(lines)

    def _as_inputs(self, inputs) -> List[torch.Tensor]:
        if self.params is None:
            raise RuntimeError("call init() before running the network")
        return [self._batch(x) for x in inputs]

    def _batch(self, a):
        """An array as a tensor on the network's device: a tensor already
        there is used as it is (no copy)."""
        return None if a is None else tr.as_tensor(a).to(self.device)

    def _forward(self, params, inputs: Sequence[torch.Tensor], *,
                 train: bool = False, stop_at_outputs: bool = False,
                 carries: Optional[Dict[str, tuple]] = None, rng=None,
                 masks: Optional[Sequence] = None):
        """Forward over the DAG with `params`. Returns (acts, new_state,
        mask_map): every vertex's activation, the running state after the
        walk (updated by vertices that track statistics when `train`) and
        every vertex's output mask, the network inputs' being `masks` (one
        per input, None for none). With `stop_at_outputs` an output
        vertex's activation is its input, for its loss, and its mask its
        input's. With `carries` (see `_init_carries`) a recurrent vertex
        scans from its entry and the entry is replaced by its new carry, in
        place. With `rng` (a step's draws) and `train`, the vertex at
        position i of `topo` takes `rng.split(len(topo))[i]`."""
        acts: Dict[str, object] = dict(zip(self.conf.network_inputs, inputs))
        mask_map: Dict[str, Optional[torch.Tensor]] = dict(zip(
            self.conf.network_inputs, masks or [None] * len(inputs)))
        new_state = dict(self.state)
        outputs = set(self.conf.network_outputs)
        rngs = (rng.split(len(self.topo)) if rng is not None
                else [None] * len(self.topo))
        from deeplearning4j_tpu_torch.parallel import layout as layout_mod

        # params sharded at rest (ParallelWrapper's fsdp or model axis):
        # each vertex's are gathered right before use, inside its remat
        # scope, so a remat policy's backward gathers again
        arr = self._shard_layout
        for name, r in zip(self.topo, rngs):
            v = self.conf.vertices[name]
            vin = [acts[x] for x in self.conf.vertex_inputs[name]]
            vmasks = [mask_map.get(x) for x in self.conf.vertex_inputs[name]]
            if stop_at_outputs and name in outputs and \
                    isinstance(self.layer(name), BaseOutputLayer):
                acts[name] = vin[0] if len(vin) == 1 else vin
                mask_map[name] = vmasks[0] if vmasks else None
                continue
            layer = self.layer(name)
            if carries is not None and name in carries:
                acts[name], carries[name] = layout_mod.apply_layer(
                    arr, name, layer, params[name],
                    functools.partial(tr.layer_scan, layer, train), vin[0],
                    carries[name], vmasks[0], rng=r)
            else:
                acts[name], st = layout_mod.apply_layer(
                    arr, name, layer, params[name],
                    functools.partial(_vertex_forward, v, self.state[name],
                                      train), vin, vmasks,
                    remat=(layer.remat if train and layer is not None
                           else None), rng=r)
                if train:
                    new_state[name] = st
            mask_map[name] = v.propagate_mask(vmasks, self._vin_types[name])
        return acts, new_state, mask_map

    def output(self, *inputs):
        """Forward to all output vertices. Inputs are arrays or tensors in
        the JAX package's layout (NHWC for images); they are moved to the
        network's device. Returns a tensor on that device (a list when the
        graph has several outputs)."""
        with torch.inference_mode():
            acts, *_ = self._forward(self.params, self._as_inputs(inputs))
        outs = [acts[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *inputs) -> List[torch.Tensor]:
        """Input + vertex activations in topological order (inputs lead),
        inference mode, as in the JAX package."""
        with torch.inference_mode():
            arrs = self._as_inputs(inputs)
            acts, *_ = self._forward(self.params, arrs)
        return list(arrs) + [acts[name] for name in self.topo]

    # ---- stateful RNN inference (rnnTimeStep) ----
    def _recurrent_vertices(self, for_streaming: bool = False) -> List[str]:
        """The LayerVertex names whose layer is recurrent, in topological
        order. for_streaming (rnn_time_step) rejects a layer that is not
        streamable: a bidirectional layer's backward scan needs the
        sequence end (tBPTT takes it: its backward half restarts in every
        window). Both reject a LastTimeStep around a recurrent layer,
        whose state no carry reaches."""
        out = []
        for name in self.topo:
            layer = self.layer(name)
            if isinstance(layer, BaseRecurrent):
                if for_streaming and not layer.streamable:
                    raise ValueError(
                        f"vertex {name!r} ({type(layer).__name__}) is "
                        f"bidirectional: rnnTimeStep needs a forward-only "
                        f"state carry")
                out.append(name)
            elif (isinstance(layer, LastTimeStep)
                  and isinstance(layer._inner, BaseRecurrent)):
                raise ValueError(
                    f"vertex {name!r} wraps a recurrent layer in "
                    f"LastTimeStep: its inner state cannot be carried "
                    f"across rnnTimeStep/tBPTT chunks; restructure as a "
                    f"recurrent layer + LastTimeStepVertex")
        return out

    def _init_carries(self, batch: int, for_streaming: bool = False
                      ) -> Dict[str, tuple]:
        return {name: self.layer(name).init_carry(batch, self.device)
                for name in self._recurrent_vertices(for_streaming)}

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_time_step(self, *inputs):
        """Feed one or more timesteps through the DAG, carrying every
        recurrent vertex's state across calls. Inputs [b, t, f], or [b, f]
        for a single step (then each output is [b, n_out]). Returns a
        tensor on the network's device (a list for several outputs)."""
        with torch.inference_mode():
            arrs = self._as_inputs(inputs)
            single = arrs[0].dim() == 2
            if single:
                arrs = [a[:, None, :] if a.dim() == 2 else a for a in arrs]
            carries = self._rnn_carries
            if carries is None:
                carries = self._init_carries(arrs[0].shape[0],
                                             for_streaming=True)
            carries = dict(carries)  # a failed call keeps the old state
            acts, *_ = self._forward(self.params, arrs, carries=carries)
            self._rnn_carries = carries
        outs = [acts[o] for o in self.conf.network_outputs]
        if single:
            outs = [o[:, 0] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    # ---- training (the JAX package's train step, eagerly) ----
    def _reg_score(self, params) -> torch.Tensor:
        """The l1/l2 penalty over every layer vertex's `regularizable`
        params (the JAX ComputationGraph counts no bias terms)."""
        total = torch.zeros((), device=self.device)
        for name, v in self.conf.vertices.items():
            if isinstance(v, LayerVertex) and params[name]:
                total = tr.layer_penalty(v.layer, params[name],
                                         self.conf.defaults, biases=False,
                                         total=total, key=name,
                                         arr=self._shard_layout)
        return total

    def _loss(self, params, inputs, labels, fmasks=None, lmasks=None,
              train: bool = True, rng=None, carries=None):
        """(score, new_state): the sum over the output vertices of each
        one's loss on its input (its weight noise from `rng` folded) under
        its labels mask, else the mask that reached its input, plus the
        l1/l2 penalty. `fmasks` / `lmasks`: one per network input / output
        (None for none), or None. With `carries` the recurrent vertices
        scan from them and leave their new carries there."""
        acts, new_state, mask_map = self._forward(
            params, inputs, train=train, stop_at_outputs=True, rng=rng,
            masks=fmasks, carries=carries)
        total = torch.zeros((), device=self.device)
        for i, (name, y) in enumerate(zip(self.conf.network_outputs, labels)):
            layer = self.layer(name)
            if not isinstance(layer, BaseOutputLayer):
                raise TypeError(f"output vertex {name!r} must wrap an output "
                                f"layer (Output, RnnOutput, LossLayer)")
            lmask = lmasks[i] if lmasks is not None else None
            if lmask is None:
                lmask = mask_map.get(name)
            from deeplearning4j_tpu_torch.parallel import (
                layout as layout_mod,
            )

            score, _, new_state[name] = layout_mod.apply_layer(
                self._shard_layout, name, layer, params[name],
                functools.partial(tr.layer_loss, layer, self.state[name],
                                  train), acts[name], y, lmask, rng=rng)
            total = total + score
        return total + self._reg_score(params), new_state

    def _apply_updates(self, grads, iteration: int) -> None:
        """Per vertex with params, in place: gradient normalization, the
        updater rule at the scheduled learning rate, params -= step,
        constraints (`_training.update_layer`)."""
        for name in self.topo:
            if grads[name]:
                self.opt_state[name] = tr.update_layer(
                    self.layer(name), self.conf.defaults,
                    self._updaters[name], self.params[name], grads[name],
                    self.opt_state[name], iteration, key=name,
                    arr=self._shard_layout)

    def _masks(self, masks):
        return None if masks is None else [self._batch(m) for m in masks]

    def _tbptt_mds(self, mds: MultiDataSet) -> bool:
        """Whether `mds` trains by tBPTT: the configuration asks for it,
        the first features and every label have a time axis (per-sequence
        labels cannot be cut into windows; the JAX package's
        `_tbptt_mds`)."""
        return (self.conf.defaults.backprop_type == "tbptt"
                and np.ndim(mds.features[0]) == 3
                and all(np.ndim(y) == 3 for y in mds.labels))

    def _stage(self, mds: MultiDataSet):
        """(inputs, labels, fmasks, lmasks) of `mds` on the device."""
        return ([self._batch(x) for x in mds.features],
                [self._batch(y) for y in mds.labels],
                self._masks(mds.features_masks),
                self._masks(mds.labels_masks))

    def _fit_mds(self, mds: MultiDataSet) -> None:
        """One updater step on one batch, or one per window when it trains
        by tBPTT (`_tbptt_mds`). A line-search `optimization_algo` trains
        with the SGD updater step here, as the JAX package's graph does."""
        batch = self._stage(mds)
        if self._tbptt_mds(mds):
            self._fit_tbptt(*batch)
        else:
            self._step(*batch)

    def _fit_tbptt(self, inputs, labels, fmasks, lmasks) -> None:
        """Truncated BPTT through the DAG (the JAX package's `_fit_tbptt`):
        windows of `tbptt_fwd_length` steps of every input, label and
        mask, each one updater step; the recurrent vertices' carries start
        at zero and pass from window to window detached."""
        if not self._checked_bidir_tbptt:
            warn_bidir_tbptt([n for n in self._recurrent_vertices()
                              if not self.layer(n).streamable])
            self._checked_bidir_tbptt = True
        T, L = inputs[0].shape[1], self.conf.defaults.tbptt_fwd_length
        carries = self._init_carries(inputs[0].shape[0])

        def window(arrays, sl):
            return None if arrays is None else [
                None if a is None else a[:, sl].contiguous() for a in arrays]

        for t0 in range(0, T, L):
            sl = slice(t0, min(t0 + L, T))
            self._step(window(inputs, sl), window(labels, sl),
                       window(fmasks, sl), window(lmasks, sl),
                       carries=carries)

    def _device_step(self, inputs, labels, fmasks, lmasks, carries=None,
                     iteration: Optional[int] = None) -> torch.Tensor:
        """The device half of one updater step: loss, gradients, updates
        and running state, with no host read; returns the score as a 0-d
        device tensor. `iteration` (default `self.iteration`) is the
        step's for the schedules and `iteration_scope` (a step window
        passes it0 + j). With `carries` the recurrent vertices start from
        them and leave their new carries there, detached."""
        it = self.iteration if iteration is None else iteration
        rng = tr.step_draws(self.draws.step())
        with iteration_scope(it):
            score, new_state, grads = tr.value_and_grad(
                lambda: self._loss(self.params, inputs, labels, fmasks,
                                   lmasks, rng=rng, carries=carries),
                self.params)
        if carries is not None:
            for name, c in carries.items():
                carries[name] = tr.detach_carry(c)
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

    def _step(self, inputs, labels, fmasks, lmasks, carries=None) -> None:
        """One updater step on one batch (or tBPTT window): the device
        step, one host read of its score, the bookkeeping."""
        score = self._device_step(inputs, labels, fmasks, lmasks, carries)
        self._bookkeep(float(score), tr.batch_rows(inputs[0]))

    def _engine_loop(self):
        """This graph's wiring of `training.engine.WindowedFitLoop`: a
        batch that does not train by tBPTT is staged on the device for a
        step window, the device step is `_device_step`."""
        from deeplearning4j_tpu_torch.training.engine import WindowedFitLoop

        def to_mds(ds):
            return (ds if isinstance(ds, MultiDataSet)
                    else MultiDataSet.from_dataset(ds))

        def stage(ds):
            mds = to_mds(ds)
            if self._tbptt_mds(mds):
                return None
            batch = self._stage(mds)
            return tuple(batch), int(batch[0][0].shape[0])

        return WindowedFitLoop(self, raw_step=self._device_step, stage=stage,
                               exec_one=lambda ds: self._fit_mds(to_mds(ds)))

    @staticmethod
    def _as_batches(data, labels=None, place=None):
        """A function giving one pass of MultiDataSets over `data`; a
        DataSetIterator is wrapped in AsyncDataSetIterator for the pass
        where it allows it (the JAX package's `_as_mds_iter`; its
        producer runs `place`), the producer shut down when the pass ends
        or is abandoned."""
        if isinstance(data, MultiDataSet):
            return lambda: iter([data])
        if isinstance(data, DataSet):
            return lambda: iter([MultiDataSet.from_dataset(data)])
        if isinstance(data, DataSetIterator):
            def one_pass():
                it_ = prefetching(data, place=place)
                try:
                    for ds in it_:
                        yield MultiDataSet.from_dataset(ds)
                finally:
                    if it_ is not data:
                        it_.shutdown()
            return one_pass
        if labels is not None:
            many = isinstance(data, (list, tuple))
            mds = MultiDataSet(
                list(data) if many else [data],
                list(labels) if isinstance(labels, (list, tuple))
                else [labels])
            return lambda: iter([mds])
        raise TypeError(f"Cannot iterate {type(data)}")

    def fit(self, data, labels=None, epochs: int = 1,
            **attachments) -> "ComputationGraph":
        """fit(MultiDataSet | DataSet | DataSetIterator | (features,
        labels)): one training step per batch (per tBPTT window), `epochs`
        passes (ComputationGraph.fit), through `training.engine.
        TrainingRun`: `checkpoint_manager=` resumes from its newest
        checkpoint first (`epochs` is the total target) and saves at each
        epoch end; the listeners see on_fit_start, on_epoch_start /
        on_epoch_end and on_fit_end around the steps. After each step
        `score_` holds its loss (with the l1/l2 penalty),
        `last_batch_size` its rows, and every listener's
        `iteration_done(net, iteration, score)` has run.
        `DL4J_TPU_STEP_WINDOW` > 1 runs the standard steps in windows of
        that many with one host read each; `DL4J_TPU_DEVICE_PREFETCH`
        copies an iterator's batches to the card on its producer."""
        from deeplearning4j_tpu_torch.training.engine import (
            TrainingRun,
            device_prefetch_place,
        )

        if self.params is None:
            raise RuntimeError("call init() before fit()")
        run = TrainingRun(self, epochs=epochs, **attachments)
        loop = self._engine_loop()
        return run.execute(
            lambda batches: self._run_epoch(batches, loop),
            self._as_batches(data, labels,
                             place=device_prefetch_place(self.device)))

    def _run_epoch(self, batches, loop) -> None:
        """One pass of `fit` through the engine loop `loop`: a step (or
        tBPTT windows) per MultiDataSet; the pass is closed even when a
        step raises, which stops its prefetch producer."""
        try:
            loop.run_epoch(batches)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()

    def score(self, data) -> float:
        """The loss on a DataSet or MultiDataSet with the running
        statistics (train=False), under its masks, penalty included
        (score(DataSet))."""
        mds = (MultiDataSet.from_dataset(data) if isinstance(data, DataSet)
               else data)
        with torch.no_grad():
            s, _ = self._loss(self.params,
                              [self._batch(x) for x in mds.features],
                              [self._batch(y) for y in mds.labels],
                              self._masks(mds.features_masks),
                              self._masks(mds.labels_masks), train=False)
        return float(s)

    # ---- evaluation (the JAX package's doEvaluation family) ----
    @staticmethod
    def _as_eval_mds(item):
        return (MultiDataSet.from_dataset(item) if isinstance(item, DataSet)
                else item)

    def do_evaluation(self, iterator, *evaluations):
        """One pass over a DataSet or MultiDataSet iterator feeding every
        evaluator (ComputationGraph.doEvaluation). Graphs with several
        inputs are fine; the graph must have one output (the reference's
        rule): `evaluate_outputs` takes several."""
        from deeplearning4j_tpu_torch.eval import host, mask_aware_feeder

        if len(self.conf.network_outputs) != 1:
            raise ValueError(
                "do_evaluation requires a single-output graph "
                f"(have {len(self.conf.network_outputs)}); use "
                "evaluate_outputs() for per-output evaluation")
        feeders = [mask_aware_feeder(ev) for ev in evaluations]
        for item in iterator:
            mds = self._as_eval_mds(item)
            out = host(self.output(*mds.features))
            lmask = (mds.labels_masks[0]
                     if mds.labels_masks is not None else None)
            for feed in feeders:
                feed(mds.labels[0], out, lmask)
        return list(evaluations)

    def evaluate_outputs(self, iterator, evaluations):
        """Each output of a multi-output graph evaluated in one pass:
        `evaluations` maps an output vertex name (or index) to an
        evaluator or a list of them; each is fed its output's predictions,
        labels and labels mask per batch. Returns `evaluations`."""
        from deeplearning4j_tpu_torch.eval import host, mask_aware_feeder

        names = list(self.conf.network_outputs)
        by_idx: Dict[int, list] = {}
        for key, evs in evaluations.items():
            idx = key if isinstance(key, int) else names.index(key)
            if not 0 <= idx < len(names):
                raise ValueError(f"no output #{idx} (outputs: {names})")
            evs = evs if isinstance(evs, (list, tuple)) else [evs]
            by_idx[idx] = [mask_aware_feeder(ev) for ev in evs]
        for item in iterator:
            mds = self._as_eval_mds(item)
            outs = self.output(*mds.features)
            if len(names) == 1:
                outs = [outs]
            for idx, feeders in by_idx.items():
                out = host(outs[idx])
                lmask = (mds.labels_masks[idx]
                         if mds.labels_masks is not None else None)
                for feed in feeders:
                    feed(mds.labels[idx], out, lmask)
        return evaluations

    def _eval_with(self, iterator, ev):
        return self.do_evaluation(iterator, ev)[0]

    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval import Evaluation

        return self._eval_with(iterator, Evaluation())

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.eval import RegressionEvaluation

        return self._eval_with(iterator, RegressionEvaluation())

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        from deeplearning4j_tpu_torch.eval import ROC

        return self._eval_with(iterator, ROC(threshold_steps))

    def evaluate_roc_multi_class(self, iterator, threshold_steps: int = 0):
        from deeplearning4j_tpu_torch.eval import ROCMultiClass

        return self._eval_with(iterator, ROCMultiClass(threshold_steps))

    def evaluate_calibration(self, iterator, reliability_bins: int = 10,
                             histogram_bins: int = 50):
        from deeplearning4j_tpu_torch.eval import EvaluationCalibration

        return self._eval_with(
            iterator, EvaluationCalibration(reliability_bins, histogram_bins))

    def set_listeners(self, *listeners) -> "ComputationGraph":
        self.listeners = list(listeners)
        return self

    def get_param_table(self) -> Dict[str, np.ndarray]:
        """"vertex/param" -> numpy array in the interchange layout (the JAX
        package's: conv kernels HWIO), so both packages' tables compare."""
        flat = {}
        for name in self.topo:
            layer = self.layer(name)
            for pname, t in tr.whole_params(self, name).items():
                if layer is not None:
                    t = layer.to_interchange(pname, t)
                # a copy: the JAX package's table is a snapshot
                flat[f"{name}/{pname}"] = t.detach().to(
                    "cpu", copy=True).numpy()
        return flat
