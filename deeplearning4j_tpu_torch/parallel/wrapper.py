"""ParallelWrapper over torch.distributed: the dcn, data, model, fsdp, seq
and pipe axes (counterpart of deeplearning4j_tpu/parallel/wrapper.py; the
reference's ParallelWrapper.java:59-73 trains replicas on several
devices).

The JAX wrapper runs one SPMD program over its mesh: the global batch is
sharded over 'data', params are placed by the layers' partition specs
(and over 'fsdp'), and GSPMD turns the step into the single-device step
on the global batch. The port runs one process per rank on a grid of
ranks (`parallel.mesh.build_mesh`) and computes the same step on purpose:

- every rank iterates the same iterator (the port's ListDataSetIterator
  shuffles from its seed and the epoch, so the ranks agree; a checksum of
  the first batch of each epoch, all-reduced, raises if they do not); the
  global batch is padded to a multiple of the data axis as the JAX
  `_pad_batch` pads it (the last row repeated, the padded rows' labels
  mask zeroed where there is one), and each rank takes its data
  coordinate's contiguous block of rows: the model and fsdp ranks of one
  data coordinate hold the same rows, as the JAX wrapper splits its batch
  over 'data' only;
- the network's own step runs on those rows (`MultiLayerNetwork.
  _fit_batch` or `ComputationGraph._fit_mds`: the standard step or its
  tBPTT windows, masks sliced with the rows) with an `nn.shard.BatchShard`
  of the data axis installed: each rank's loss is its share of the global
  mean, BatchNorm's statistics and dropout's masks are the global
  batch's, the l1/l2 penalty counts once, and the gradients and the score
  are summed over the data axis in flat buckets after the backward,
  before gradient normalization and the updater (`nn/shard.py`). The
  reduce runs at world size 1 too;
- on the model and fsdp axes the params live sharded (`_place_params`:
  the layers' `tensor_partition_specs`, with the fsdp axis composed on by
  `parallel.layout`), the updater slots mirror them and scalars
  replicate; each layer gathers its fsdp slices on use, and computes on
  its model slices or gathers them (`nn.layers.base`), so every rank's
  step is the single process's (`parallel/layout.py`);
- construction broadcasts rank 0's params, updater slots, running state,
  counters and dropout generator to every rank, as
  DistributedDataParallel broadcasts its module, then cuts each rank's
  slices.

On the seq axis (sequence parallelism, the JAX wrapper's shard_map over
(data, seq)): every layer and graph vertex must declare `sp_safe` (the JAX
message refuses the others: LSTMs, pooling, time-structural vertices,
input preprocessors), the sequence length must divide by the axis, and
each rank takes rows block d and time block s of the features, labels and
masks (None masks stay None, so no mask rides the ring). The step runs
inside `ring.sequence_parallel(grid.seq)`, so MultiHeadAttention computes
ring attention over the axis and PositionEmbedding indexes global
offsets, with an `nn.shard.KeyedShard` over data x seq installed: each
rank's loss is its share of the global masked mean BEFORE the gradient
(ring attention's backward sends cotangents across shards, so each
carries its own shard's weight), the penalty counts once, BatchNorm's
statistics span both axes, each shard draws with the step's draws folded
by d * n_seq + s, and the gradients are summed over data x seq. It
composes with the model axis (tp x sp: the ring on each rank's heads).

On the pipe axis (GPipe): the layer list but its output layer is cut into
`pipe` contiguous stages balanced by parameter count (`_pp_stage_bounds`),
every rank holding every param. The local batch is cut into M =
`microbatches` (else the largest divisor of it up to `pipe`)
microbatches; stage s runs its layers on each microbatch in turn, taking
the boundary activation from stage s - 1 and sending its own to s + 1
(`AxisGroup.send` / `recv`, heterogeneous shapes included: the first
message of a new batch shape carries its shape). The last stage applies
the output layer to the joined outputs, its loss (with the penalty) being
the only one; the backward runs the schedule in reverse, each stage
sending its input's cotangent back, and the gradients and the score are
summed over data x pipe, which completes the stage-owned gradients. Each
(data shard, microbatch) draws its own masks. The JAX refusals stand:
not a MultiLayerNetwork, no loss layer, running state (BatchNorm), fewer
pipelineable layers than stages, feature masks.

So after each step the ranks hold the single process's params between
them, and `score_`, `last_batch_size` (the unpadded global batch) and the
listeners see what a single-process `fit` on the global batch gives.
`get_param_table`, saves and checkpoints give whole params on every rank
(collectively), and a checkpoint restores into any factorization of the
grid. A line-search `optimization_algo` takes the SGD updater step here,
with the JAX package's warning once per network. Under
`DL4J_TPU_STEP_WINDOW` = K > 1 the engine's window stages K global
batches, each rank's rows on the device with the batch's `BatchShard`,
runs each one's shard step under its shard, and every rank reads the
window's scores once (the seq and pipe steps keep per-step dispatch, as
in the JAX package). fsdp does not compose with seq, pipe or tBPTT, nor
tBPTT with seq or pipe, nor pipe with seq or model, as in the JAX
package. The reduce waits for the whole backward (its overlap with the
backward is queued as perf work).

On the dcn axis (the outermost, across nodes): the JAX wrapper shards its
batch over "data" alone (`_put`), so each dcn row of the grid is a
replica of the whole data x fsdp x model x seq x pipe step. Every rank of
a dcn row takes its data coordinate's rows, exactly as its peers in the
other rows do, and computes the same gradients; no gradient is reduced
over dcn, since the JAX program reduces over none. dcn composes with every
axis the wrapper runs.

Telemetry and faults, as in the JAX wrapper: `fit` runs as the phase
"ParallelWrapper.fit" (heartbeats, crash bundles), its steps are "step"
spans of category "collective", and the `DL4J_TPU_CHAOS` fault point
`collective` fires before every step and every step window. The JAX
wrapper's per-device trace lanes wait for `telemetry/introspect.py`
(ROADMAP A.11 item 3).
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.layers.base import iteration_scope
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
    prefetching,
)
from deeplearning4j_tpu_torch.models import _training as tr
from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn.dropout import Draws
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.parallel import ring
from deeplearning4j_tpu_torch.resilience import chaos

# dtypes of a pipeline boundary's shape message
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)


class ParallelWrapper:
    """Wraps a MultiLayerNetwork, or a ComputationGraph with one input and
    one output, for training over the process group:

        mesh.init_process_group("file:///tmp/rdv", rank, world_size)
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=world_size))
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=2, model=2))
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(fsdp=2, model=2))
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=2, seq=2))
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(model=2, seq=2))
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=2, pipe=2),
                             microbatches=4)
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(dcn=2, data=2))
        pw.fit(iterator, epochs=2)

    Every rank runs the same calls. `mesh` is a `parallel.mesh.Grid`
    (default: `build_mesh(mesh_spec)`, or every rank on the data axis).
    `averaging_frequency` and `report_score_after_averaging` keep the JAX
    signature: the gradients are summed at every step, as there
    (`averaging_frequency` 1). `microbatches` is the pipe axis's GPipe
    depth. `prefetch_buffer` is the depth of the AsyncDataSetIterator that
    fit wraps an iterator in. `stats` counts the gradient reduce's bytes
    and collectives (and times them when `stats.events` is a list);
    `collective_stats()` adds every axis's."""

    def __init__(self, model, mesh: Optional[mesh_mod.Grid] = None,
                 mesh_spec: Optional[mesh_mod.MeshSpec] = None,
                 workers: Optional[int] = None,
                 averaging_frequency: int = 1, prefetch_buffer: int = 4,
                 report_score_after_averaging: bool = True,
                 microbatches: Optional[int] = None):
        self.model = model
        spec = (mesh.spec if mesh is not None
                else mesh_spec or mesh_mod.MeshSpec.data_parallel(workers))
        _refuse(spec, getattr(model.conf.defaults, "backprop_type", None)
                == "tbptt")
        self._sp = spec.seq > 1
        self._pp = spec.pipe > 1
        if self._sp:
            self._check_sp_safe(model)
        if self._pp:
            self._check_pp_model(spec.pipe)
        if mesh is None:
            mesh = mesh_mod.build_mesh(spec)
        self.mesh = mesh
        self.averaging_frequency = max(1, averaging_frequency)
        self.prefetch_buffer = prefetch_buffer
        self.report_score_after_averaging = report_score_after_averaging
        self.microbatches = microbatches
        self.stats = shard_mod.ReduceStats()
        self._check_model()
        self._broadcast_from_rank0()
        self._place_params()
        self._pp_bounds = (self._pp_stage_bounds(spec.pipe) if self._pp
                           else None)
        self._pp_shapes, self._pp_told = {}, set()

    def _check_model(self) -> None:
        model, mesh = self.model, self.mesh
        if model.params is None:
            raise RuntimeError("call init() before wrapping the network")
        if isinstance(model, ComputationGraph) and (
                len(model.conf.network_inputs) != 1
                or len(model.conf.network_outputs) != 1):
            # the JAX wrapper's own limit: it wraps "a MultiLayerNetwork
            # (or ComputationGraph with single in/out)" and its step takes
            # one features and one labels array
            raise ValueError("ParallelWrapper trains a ComputationGraph "
                             "with one input and one output, as the JAX "
                             "package's does")
        if mesh.backend == "nccl" and model.device.type != "cuda":
            raise ValueError(f"a network on {model.device} under the NCCL "
                             f"backend: initialise gloo for the CPU")
        if mesh.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {mesh.backend!r}: use nccl or gloo")

    def _check_sp_safe(self, model) -> None:
        """Refuses any layer or graph vertex whose computation crosses the
        time axis (sp_safe False): under a sharded sequence it would
        compute chunk-local results (the JAX wrapper's message)."""
        from deeplearning4j_tpu_torch.nn.graph_vertices import LayerVertex

        def refuse(kind, name):
            raise ValueError(
                f"{kind} {name} reduces/restructures the time axis and "
                f"cannot run with the sequence sharded (sp_safe=False); "
                f"sequence parallelism supports per-timestep and "
                f"ring-aware components only")

        if not isinstance(model, ComputationGraph):
            for layer in model.layers:
                if not getattr(layer, "sp_safe", False):
                    refuse("layer", type(layer).__name__)
            if getattr(model.conf, "input_preprocessors", None):
                refuse("input preprocessor", str(sorted(
                    model.conf.input_preprocessors)))
            return
        for name, v in model.conf.vertices.items():
            if isinstance(v, LayerVertex):
                if not getattr(v.layer, "sp_safe", False):
                    refuse("layer", f"{type(v.layer).__name__} ('{name}')")
            elif not getattr(v, "sp_safe", False):
                refuse("vertex", f"{type(v).__name__} ('{name}')")

    def _check_pp_model(self, pp: int) -> None:
        """The pipe axis's refusals (the JAX wrapper's messages)."""
        from deeplearning4j_tpu_torch.nn.layers.output import BaseOutputLayer

        model = self.model
        if isinstance(model, ComputationGraph):
            raise ValueError(
                "pipeline parallelism needs a sequential layer stack "
                "(MultiLayerNetwork); DAG ComputationGraphs have no single "
                "stage cut — train them under data/tensor/sequence axes")
        if not isinstance(model.layers[-1], BaseOutputLayer):
            raise ValueError(
                "pipeline parallelism requires a loss-bearing final layer")
        if _leaves(model.state):
            raise ValueError(
                "pipeline parallelism cannot thread running state (e.g. "
                "BatchNorm statistics) through microbatched stages; train "
                "stateful nets under data/tensor parallelism instead")
        if len(model.layers) - 1 < pp:
            raise ValueError(
                f"{len(model.layers) - 1} pipelineable layers cannot fill "
                f"pipe={pp} stages")

    def _pp_stage_bounds(self, pp: int):
        """Contiguous [lo, hi) layer ranges per stage, balanced by param
        count, at least one layer per remaining stage; the output layer
        stays outside the stages (the JAX wrapper's rule)."""
        model = self.model
        n = len(model.layers) - 1
        sizes = [1 + sum(t.numel() for t in _leaves(
            model.params[f"layer_{i}"])) for i in range(n)]
        bounds, lo = [], 0
        remaining = float(sum(sizes))
        for s in range(pp):
            rem = pp - s - 1
            if rem == 0:
                bounds.append((lo, n))
                break
            target = remaining / (rem + 1)
            hi = lo + 1
            acc = float(sizes[lo])
            while (hi < n - rem
                   and abs(acc + sizes[hi] - target) <= abs(target - acc)):
                acc += sizes[hi]
                hi += 1
            bounds.append((lo, hi))
            remaining -= acc
            lo = hi
        return bounds

    def _broadcast_from_rank0(self) -> None:
        """Every rank takes rank 0's params (in place), running state,
        updater slots, iteration and epoch, and the state of its dropout
        generator where it is a `Draws`. A network sharded by an earlier
        wrapper is made whole first."""
        model = self.model
        _unshard(model)
        counters = torch.tensor([model.iteration, model.epoch],
                                dtype=torch.int64, device=model.device)
        tensors = (_leaves(model.params) + _leaves(model.state)
                   + _leaves(model.opt_state) + [counters])
        gen = model.draws.generator if isinstance(model.draws, Draws) \
            else None
        if gen is not None:
            gen_state = gen.get_state().to(model.device)
            tensors.append(gen_state)
        with torch.no_grad():
            shard_mod.broadcast(tensors, 0, self.mesh.group)
        model.iteration, model.epoch = (int(v) for v in counters.tolist())
        if gen is not None:
            gen.set_state(gen_state.cpu())

    def _place_params(self) -> None:
        """Params placed by the layers' tensor-parallel specs composed with
        the fsdp axis (`parallel.layout.fsdp_param_specs`): each rank keeps
        its slices, the updater slots that mirror a layer's params keep
        the same slices, scalars (Adam's t) and running state stay whole.
        Where nothing splits (data axis only, or no layer that splits) the
        network is left as it is."""
        from deeplearning4j_tpu_torch.parallel import layout as layout_mod

        model, mesh = self.model, self.mesh
        if mesh.model.size == 1 and mesh.fsdp.size == 1:
            return
        specs = layout_mod.fsdp_param_specs(mesh, model)
        if not any(pl.axes for tree in specs.values()
                   for pl in tree.values()):
            return
        layout_mod.FsdpArrangement(mesh, specs).place(model)

    def collective_stats(self) -> dict:
        """Collectives launched and bytes moved so far: the gradient
        reduce (over data, data x seq or data x pipe), and every other
        group's (the model, fsdp and shard groups', the ring's hops on
        seq, the stage hops on pipe; none on dcn)."""
        out = {"data": self.stats}
        for name in ("model", "fsdp", "shard", "seq", "pipe", "expert",
                     "dcn"):
            out[name] = self.mesh.axis(name).stats
        return {k: {"collectives": v.collectives, "bytes": v.bytes}
                for k, v in out.items()}

    def fit(self, iterator, epochs: int = 1, **attachments):
        """`epochs` passes over `iterator` (a DataSetIterator, or a DataSet
        as one batch): one step per global batch, each equal to the
        single-process step on it, through `training.engine.TrainingRun`
        (the wrapped network's listeners' lifecycle events;
        `checkpoint_manager=` restores the wrapped network before any step,
        `epochs` the total target; every rank saves to its own manager).
        An iterator is wrapped in AsyncDataSetIterator (depth
        `prefetch_buffer`) where it allows it. Returns the wrapped
        network."""
        from deeplearning4j_tpu_torch.training.engine import (
            TrainingRun,
            WindowedFitLoop,
            device_prefetch_place,
        )

        model = self.model
        run = TrainingRun(model, "ParallelWrapper.fit", epochs=epochs,
                          **attachments)
        if model._shard_layout is None:
            # whole again after sync_to_host (a no-op where nothing splits)
            self._place_params()
        if not isinstance(model, ComputationGraph):
            model._warn_sgd_fallback()
        batches = iterator
        if isinstance(iterator, DataSet):
            batches = ListDataSetIterator(iterator,
                                          batch=iterator.num_examples())
        elif isinstance(iterator, DataSetIterator):
            batches = prefetching(iterator, self.prefetch_buffer,
                                  place=device_prefetch_place(model.device))
        # the JAX wrapper's chaos `collective` site before every step and
        # every window; its steps are "collective" spans
        loop = WindowedFitLoop(
            model, raw_step=self._shard_step, stage=self._stage,
            exec_one=self._fit_global,
            on_dispatch=lambda: chaos.fault_point("collective"),
            span_category="collective")

        def run_epoch(epoch_batches):
            def checked():
                for i, ds in enumerate(epoch_batches):
                    if i == 0:
                        self._check_ranks_agree(ds)
                    yield ds

            loop.run_epoch(checked())

        # a prefetch producer started here is stopped here
        return run.execute(run_epoch, batches, loop=loop, cleanup=getattr(
            batches, "shutdown", None) if batches is not iterator else None)

    def _local(self, ds: DataSet):
        """(this rank's rows of `ds` padded to a multiple of the ranks,
        and under the seq axis its time block, the batch's shard)."""
        mesh = self.mesh
        data = mesh.data
        b, n = ds.num_examples(), data.size
        if b % n:
            ds = pad_batch(ds, n - b % n)
        arrays = mesh_mod.shard_batch_tree(mesh, [
            ds.features, ds.labels, ds.features_mask, ds.labels_mask])
        if not self._sp:
            # the pipeline draws per (data shard, microbatch)
            kind = shard_mod.KeyedShard if self._pp else shard_mod.BatchShard
            shard = kind(data.group, data.rank, n, ds.num_examples(), b,
                         self.stats)
            return DataSet(*arrays), shard
        seq, both = mesh.seq, mesh.batch
        t = ds.features.shape[1]
        if t % seq.size:
            raise ValueError(
                f"sequence length {t} must divide by the seq axis "
                f"({seq.size}); bucket or pad the iterator "
                f"(BucketSequenceIterator) to a multiple")
        arrays = [None if a is None or a.ndim < 2 else
                  _contiguous(a[:, seq.rank * (a.shape[1] // seq.size):
                                (seq.rank + 1) * (a.shape[1] // seq.size)])
                  for a in arrays]
        shard = shard_mod.KeyedShard(both.group, both.rank, both.size,
                                     ds.num_examples(), b, self.stats)
        return DataSet(*arrays), shard

    def _tbptt(self, ds) -> bool:
        model = self.model
        if isinstance(model, ComputationGraph):
            return model._tbptt_mds(MultiDataSet.from_dataset(ds))
        return model._tbptt_batch(ds)

    def _seq_context(self):
        return (ring.sequence_parallel(self.mesh.seq) if self._sp
                else contextlib.nullcontext())

    def _fit_global(self, ds: DataSet) -> None:
        """One step (or tBPTT windows) of the wrapped network on the
        global batch `ds`, this rank's rows (and time block) under its
        shard; on the pipe axis, the pipeline's step."""
        # the JAX wrapper's env-gated chaos site of the multi-device step
        # (standard and tBPTT alike): a "preempted collective" surfaces as
        # ChaosError out of fit()
        chaos.fault_point("collective")
        if self._pp:
            self._fit_pp(ds)
            return
        local, shard = self._local(ds)
        with shard_mod.installed(shard), self._seq_context():
            if isinstance(self.model, ComputationGraph):
                self.model._fit_mds(MultiDataSet.from_dataset(local))
            else:
                self.model._fit_batch(local, solver=False)

    def _stage(self, ds: DataSet):
        """A step window's staging of a global batch: this rank's rows on
        the device with the batch's shard, reporting the unpadded rows;
        None for a tBPTT batch (its windows run through `_fit_global`) and
        on the seq and pipe axes (per-step dispatch)."""
        if self._sp or self._pp or self._tbptt(ds):
            return None
        local, shard = self._local(ds)
        model = self.model
        if isinstance(model, ComputationGraph):
            args = tuple(model._stage(MultiDataSet.from_dataset(local)))
        else:
            args = tuple(model._batch(a) for a in (
                local.features, local.labels, local.features_mask,
                local.labels_mask))
        return (shard, args), shard.unpadded

    # ------------------------------------------------------------ pipe
    def _microbatches(self, b_loc: int) -> int:
        pp = self.mesh.pipe.size
        if self.microbatches:
            m = self.microbatches
            if b_loc % m:
                raise ValueError(
                    f"per-data-shard batch {b_loc} must divide into "
                    f"microbatches={m} (pad the iterator or change "
                    f"ParallelWrapper(microbatches=...))")
            return m
        # the largest divisor of the local batch up to pp (GPipe is exact
        # for any M; fewer microbatches only grow the bubble)
        return next(m for m in range(min(pp, b_loc), 0, -1)
                    if b_loc % m == 0)

    def _fit_pp(self, ds: DataSet) -> None:
        """One GPipe step on the global batch `ds` (see the module
        docstring)."""
        model = self.model
        if ds.features_mask is not None:
            raise ValueError(
                "pipeline parallelism does not thread feature masks "
                "through stages; use data/tensor/sequence axes for "
                "masked-input nets")
        local, shard = self._local(ds)
        x, y, lm = (model._batch(a) for a in (
            local.features, local.labels, local.labels_mask))
        it = model.iteration
        with shard_mod.installed(shard), iteration_scope(it):
            score = self._pp_step(x, y, lm, it)
        model._bookkeep(float(score), shard.unpadded)

    def _stage_input(self, key, dev):
        """(shape, dtype) of this stage's input for a batch of shape
        `key`: from the previous stage's shape message the first time the
        shape is seen, else remembered."""
        pipe = self.mesh.pipe
        if key not in self._pp_shapes:
            head = pipe.recv((9,), torch.int64, dev, pipe.rank - 1)
            shape = tuple(int(v) for v in head[2:2 + int(head[1])])
            self._pp_shapes[key] = (shape, _DTYPES[int(head[0])])
        return self._pp_shapes[key]

    def _tell_shape(self, key, out: torch.Tensor) -> None:
        """The shape message of this stage's output to the next stage, the
        first time a batch shape is seen."""
        if key in self._pp_told:
            return
        head = torch.zeros(9, dtype=torch.int64)
        head[0] = _DTYPES.index(out.dtype)
        head[1] = out.dim()
        head[2:2 + out.dim()] = torch.tensor(out.shape)
        self.mesh.pipe.send(head.to(out.device), self.mesh.pipe.rank + 1
                            ).wait()
        self._pp_told.add(key)

    def _pp_step(self, x, y, lm, it: int) -> torch.Tensor:
        from deeplearning4j_tpu_torch.models._training import (
            flat_items,
            layer_forward,
            layer_loss,
        )
        from deeplearning4j_tpu_torch.parallel import layout as layout_mod

        model, mesh = self.model, self.mesh
        pipe, d = mesh.pipe, mesh.data.rank
        pp, s = pipe.size, pipe.rank
        lo, hi = self._pp_bounds[s]
        layers = model.layers
        n_layers = len(layers)
        k_out = f"layer_{n_layers - 1}"
        b_loc = x.shape[0]
        M = self._microbatches(b_loc)
        bm = b_loc // M
        dev = model.device
        key = (tuple(x.shape), x.dtype)
        step = model.draws.step()
        preprocs = model.conf.input_preprocessors
        frozen = model._frozen_keys()
        leaves = []
        for k, p in model.params.items():
            if k in frozen:
                continue
            for path, t in flat_items(p):
                t.requires_grad_(True)
                leaves.append((k, path, t))

        def seg_forward(h, rngs):
            for i in range(lo, hi):
                layer = layers[i]
                if i in preprocs:
                    h = preprocs[i].transform(h, None)
                k = f"layer_{i}"
                h, _ = layout_mod.apply_layer(
                    None, k, layer, model.params[k],
                    functools.partial(layer_forward, layer, model.state[k],
                                      True), h, None, remat=layer.remat,
                    rng=rngs[i])
            return h

        ins, outs, sent = [], [], []
        with torch.enable_grad(), shard_mod.active():
            for m in range(M):
                if s == 0:
                    h = x[m * bm:(m + 1) * bm]
                else:
                    shape, dtype = self._stage_input(key, dev)
                    h = pipe.recv(shape, dtype, dev, s - 1)
                    if h.is_floating_point():
                        h.requires_grad_(True)
                rngs = shard_mod.fold_draws(step, d, m, salt=lo).split(
                    n_layers)
                out = seg_forward(h, rngs)
                if s < pp - 1:
                    self._tell_shape(key, out)
                    sent.append(pipe.send(out, s + 1))
                ins.append(h)
                outs.append(out)
            wn_rng = shard_mod.fold_draws(step, d)
            grads = [None] * len(leaves)
            if s == pp - 1:
                h_all = torch.cat([o.detach() for o in outs])
                h_all.requires_grad_(True)
                score, _, _ = layout_mod.apply_layer(
                    None, k_out, layers[-1], model.params[k_out],
                    functools.partial(layer_loss, layers[-1],
                                      model.state[k_out], True),
                    h_all, y, lm, rng=wn_rng)
                score = score + model._reg_score(model.params)
                got = torch.autograd.grad(
                    score, [t for *_, t in leaves] + [h_all],
                    allow_unused=True)
                grads = list(got[:-1])
                d_outs = list(got[-1].split(bm))
            else:
                score = torch.zeros((), device=dev)
            for h_sent in sent:
                h_sent.wait()
            back = []
            for m in reversed(range(M)):
                g = (d_outs[m] if s == pp - 1 else
                     pipe.recv(outs[m].shape, outs[m].dtype, dev, s + 1))
                want = [t for *_, t in leaves]
                takes_input = s > 0 and ins[m].requires_grad
                if takes_input:
                    want.append(ins[m])
                got = torch.autograd.grad(outs[m], want, grad_outputs=g,
                                          allow_unused=True)
                for j in range(len(leaves)):
                    if got[j] is not None:
                        grads[j] = (got[j] if grads[j] is None
                                    else grads[j] + got[j])
                if s > 0:
                    gin = got[-1] if takes_input else torch.zeros_like(
                        ins[m])
                    back.append(pipe.send(gin, s - 1))
            for h_back in back:
                h_back.wait()
        flat = [torch.zeros_like(t) if g is None else g
                for (*_, t), g in zip(leaves, grads)]
        rep = mesh.replica
        reducer = shard_mod.BatchShard(rep.group, rep.rank, rep.size,
                                       b_loc * rep.size, b_loc, self.stats)
        score, flat = reducer.reduce(score.detach(), flat)
        tree = {k: {} for k in model.params}
        for (k, path, _), g in zip(leaves, flat):
            node = tree[k]
            *parents, name = path.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[name] = g
        with torch.no_grad():
            model._apply_updates(tree, it)
        return score

    def _shard_step(self, shard, args, iteration: int):
        """The wrapped network's device step on staged rows, under their
        shard (the gradients and the score summed over the ranks)."""
        with shard_mod.installed(shard):
            return self.model._device_step(*args, iteration=iteration)

    def _check_ranks_agree(self, ds: DataSet) -> None:
        """Raises ValueError unless every rank holds the same batch: per
        array its rows, its sum and its row-weighted sum in float64, the
        largest and the smallest over the ranks compared."""
        sums = [torch.tensor([float(ds.num_examples())], dtype=torch.float64)]
        for a in (ds.features, ds.labels, ds.features_mask, ds.labels_mask):
            if a is None:
                sums.append(torch.zeros(2, dtype=torch.float64))
                continue
            t = tr.as_tensor(a)
            rows = t.reshape(t.shape[0], -1).sum(1, dtype=torch.float64)
            w = torch.arange(1, rows.shape[0] + 1, dtype=torch.float64,
                             device=rows.device)
            sums.append(torch.stack([rows.sum(), (rows * w).sum()]).cpu())
        c = torch.cat(sums)
        both = torch.cat([c, -c]).to(self.model.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.mesh.group)
        hi, lo = both[:len(c)].cpu(), -both[len(c):].cpu()
        if not torch.equal(hi, lo):
            raise ValueError(
                f"the ranks hold different batches at epoch "
                f"{self.model.epoch} (rows, sum and row-weighted sum per "
                f"array, largest {hi.tolist()} and smallest {lo.tolist()} "
                f"over the ranks): every rank must iterate the same data")

    def sync_to_host(self):
        """The wrapped network with whole params and updater slots on every
        rank (gathered from the ranks' slices, collectively), no longer
        sharded, once the device has finished its work. A later `fit`
        places them again."""
        _unshard(self.model)
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        return self.model

    # reference-API aliases, as in the JAX package: fit runs to its end on
    # every rank (a rank that stopped alone would leave the others waiting
    # in a collective), and the group belongs to the caller
    def shutdown(self):
        pass

    def stop_fit(self):
        pass


def _refuse(spec: mesh_mod.MeshSpec, tbptt: bool) -> None:
    """The JAX wrapper's refusals of axis compositions (ValueError), and
    `mesh.check_spec`'s of an empty axis."""
    sizes = spec.axis_sizes()
    sp, pp = sizes["seq"] > 1, sizes["pipe"] > 1
    if sizes["fsdp"] > 1 and (sp or pp or tbptt):
        raise ValueError(
            "fsdp composes with data/model axes only: the seq/pipe paths "
            "pin params replicated and tbptt threads host carries through "
            "per-chunk steps, so an fsdp-sharded param tree would be "
            "gathered per chunk instead of per layer; use "
            "MeshSpec(data=..., fsdp=..., model=...)")
    if tbptt and (sp or pp):
        raise ValueError(
            "truncated BPTT threads RNN carries chunk-by-chunk through "
            "time, which cannot compose with a sharded sequence axis or "
            "pipeline stages; train tbptt nets under data/tensor meshes")
    if pp and sp:
        raise ValueError(
            "pipe x seq factorization is not supported by ParallelWrapper; "
            "use parallel.transformer.ShardedTransformerLM for pp x sp")
    if pp and sizes["model"] > 1:
        raise ValueError(
            "pipe x model factorization is not supported by "
            "ParallelWrapper; use parallel.transformer.ShardedTransformerLM "
            "for pp x tp")
    mesh_mod.check_spec(spec)


def _unshard(model) -> None:
    """Whole params and updater slots in place of a sharded network's
    slices (collective over its axes); the arrangement dropped."""
    if model._shard_layout is None:
        return
    keys = list(model.params)
    with torch.no_grad():
        model.params = {k: tr.whole_params(model, k) for k in keys}
        if isinstance(model.opt_state, dict):
            model.opt_state = {k: tr.whole_slots(model, k, v)
                               for k, v in model.opt_state.items()}
        else:
            model.opt_state = [tr.whole_slots(model, k, v)
                               for k, v in zip(keys, model.opt_state)]
    model._shard_layout = None


def pad_batch(ds: DataSet, pad: int) -> DataSet:
    """`ds` with its last row repeated `pad` times (numpy arrays or
    tensors); the padded rows' labels mask zeroed where there is one, so
    they leave the loss, else they count as duplicated examples (the JAX
    package's `_pad_batch`)."""

    def padded(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    lm = padded(ds.labels_mask)
    if lm is not None:
        lm[-pad:] = 0
    return DataSet(padded(ds.features), padded(ds.labels),
                   padded(ds.features_mask), lm)


def _contiguous(a):
    """A time block as its own contiguous array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous()
    return np.ascontiguousarray(a)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
