"""ParallelWrapper's data axis on torch.distributed (counterpart of
deeplearning4j_tpu/parallel/wrapper.py; the reference's
ParallelWrapper.java:59-73 trains replicas on several devices).

The JAX wrapper runs one SPMD program over its mesh: the global batch is
sharded over 'data' and GSPMD turns the step into the single-device step
on the global batch. The port runs one process per rank, each holding a
whole replica of the network, and computes the same step on purpose:

- every rank iterates the same iterator (the port's ListDataSetIterator
  shuffles from its seed and the epoch, so the ranks agree; a checksum of
  the first batch of each epoch, all-reduced, raises if they do not); the
  global batch is padded to a multiple of the ranks as the JAX
  `_pad_batch` pads it (the last row repeated, the padded rows' labels
  mask zeroed where there is one), and each rank takes its contiguous
  block of rows;
- the network's own step runs on those rows (`MultiLayerNetwork.
  _fit_batch` or `ComputationGraph._fit_mds`: the standard step or its
  tBPTT windows, masks sliced with the rows) with an `nn.shard.BatchShard`
  installed:
  each rank's loss is its share of the global mean, BatchNorm's
  statistics and dropout's masks are the global batch's, the l1/l2
  penalty counts once, and the gradients and the score are summed over
  the ranks in flat buckets after the backward, before gradient
  normalization and the updater (`nn/shard.py`). The reduce runs at
  world size 1 too;
- construction broadcasts rank 0's params, updater slots, running state,
  counters and dropout generator to every rank, as
  DistributedDataParallel broadcasts its module.

So after each step every rank holds the same params, and `score_`,
`last_batch_size` (the unpadded global batch) and the listeners see what a
single-process `fit` on the global batch gives. Only the data axis is
ported (`parallel/mesh.py`); the model, seq, pipe and fsdp axes raise for
ROADMAP A.9. The reduce waits for the whole backward (its overlap with the
backward is queued as perf work).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
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


class ParallelWrapper:
    """Wraps a MultiLayerNetwork, or a ComputationGraph with one input and
    one output, for data-parallel training over the process group:

        mesh.init_process_group("file:///tmp/rdv", rank, world_size)
        pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=world_size))
        pw.fit(iterator, epochs=2)

    Every rank runs the same calls. `mesh` is a `parallel.mesh.DataGroup`
    (default: `build_mesh(mesh_spec)`, or every rank on the data axis).
    `averaging_frequency`, `report_score_after_averaging` and
    `microbatches` keep the JAX signature: the gradients are summed at
    every step, as there (`averaging_frequency` 1). `prefetch_buffer` is
    the depth of the AsyncDataSetIterator that fit wraps an iterator in.
    `stats` counts the gradient reduce's bytes and collectives (and times
    them when `stats.events` is a list)."""

    def __init__(self, model, mesh: Optional[mesh_mod.DataGroup] = None,
                 mesh_spec: Optional[mesh_mod.MeshSpec] = None,
                 workers: Optional[int] = None,
                 averaging_frequency: int = 1, prefetch_buffer: int = 4,
                 report_score_after_averaging: bool = True,
                 microbatches: Optional[int] = None):
        self.model = model
        if mesh is None:
            mesh = mesh_mod.build_mesh(
                mesh_spec or mesh_mod.MeshSpec.data_parallel(workers))
        self.mesh = mesh
        self.averaging_frequency = max(1, averaging_frequency)
        self.prefetch_buffer = prefetch_buffer
        self.report_score_after_averaging = report_score_after_averaging
        self.microbatches = microbatches
        self.stats = shard_mod.ReduceStats()
        self._check_model()
        self._broadcast_from_rank0()

    def _check_model(self) -> None:
        model, mesh = self.model, self.mesh
        if model.params is None:
            raise RuntimeError("call init() before wrapping the network")
        if isinstance(model, ComputationGraph) and (
                len(model.conf.network_inputs) != 1
                or len(model.conf.network_outputs) != 1):
            raise ValueError("ParallelWrapper trains a ComputationGraph "
                             "with one input and one output")
        if mesh.backend == "nccl" and model.device.type != "cuda":
            raise ValueError(f"a network on {model.device} under the NCCL "
                             f"backend: initialise gloo for the CPU")
        if mesh.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {mesh.backend!r}: use nccl or gloo")

    def _broadcast_from_rank0(self) -> None:
        """Every rank takes rank 0's params (in place), running state,
        updater slots, iteration and epoch, and the state of its dropout
        generator where it is a `Draws`."""
        model = self.model
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
            shard_mod.broadcast(tensors, dist.get_global_rank(
                self.mesh.group, 0), self.mesh.group)
        model.iteration, model.epoch = (int(v) for v in counters.tolist())
        if gen is not None:
            gen.set_state(gen_state.cpu())

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
        from deeplearning4j_tpu_torch.training.engine import TrainingRun

        model = self.model
        run = TrainingRun(model, epochs=epochs, **attachments)
        model._check_trainable()
        batches = iterator
        if isinstance(iterator, DataSet):
            batches = ListDataSetIterator(iterator,
                                          batch=iterator.num_examples())
        elif isinstance(iterator, DataSetIterator):
            batches = prefetching(iterator, self.prefetch_buffer)

        def run_epoch(epoch_batches):
            for i, ds in enumerate(epoch_batches):
                if i == 0:
                    self._check_ranks_agree(ds)
                self._fit_global(ds)

        # a prefetch producer started here is stopped here
        return run.execute(run_epoch, batches, cleanup=getattr(
            batches, "shutdown", None) if batches is not iterator else None)

    def _fit_global(self, ds: DataSet) -> None:
        b, n = ds.num_examples(), self.mesh.size
        if b % n:
            ds = pad_batch(ds, n - b % n)
        m = self.mesh
        shard = shard_mod.BatchShard(m.group, m.rank, n, ds.num_examples(),
                                     b, self.stats)
        local = DataSet(*(None if a is None else a[shard.lo:shard.hi]
                          for a in (ds.features, ds.labels,
                                    ds.features_mask, ds.labels_mask)))
        with shard_mod.installed(shard):
            if isinstance(self.model, ComputationGraph):
                self.model._fit_mds(MultiDataSet.from_dataset(local))
            else:
                self.model._fit_batch(local)

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
        """The wrapped network, once the device has finished its work
        (every rank already holds the params)."""
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


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
