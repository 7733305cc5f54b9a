"""The fit loop and its lifecycle (counterpart of
deeplearning4j_tpu/training/engine.py): step windows, device prefetch and
`TrainingRun`.

**Step windows.** `DL4J_TPU_STEP_WINDOW` = K > 1 rolls K standard steps
into one window with one host read. `WindowedFitLoop` stages each batch on
the device (`stage`), keeps staging while the batches' signature (shapes,
dtypes, which masks are None) stays the same, and at K batches, at a
change of signature, before a batch that takes its own path (a tBPTT or
solver batch, through `exec_one`) and at the epoch's end flushes: every
listener's `on_window_start`, the K device steps one after another with no
host read (the torch counterpart of the JAX package's scan: step j gets
iteration it0 + j for its schedules and `iteration_scope` and takes its
own `draws.step()` in order, so a window of K equals K single steps bit
for bit), one read of the K scores (`torch.stack(...).cpu()`), the replay
of the scores through `iteration_done` with `model._window_replay` set
(`score_`, `last_batch_size` and `iteration` advance per step; the replay
stops when a listener rewinds `iteration`, as a sentry rollback does, so
no listener sees the discarded steps), then `on_window_end`. Batches
staged before an exception in the middle of an epoch are dropped. K = 1
(the default) is the per-step loop: each batch through `exec_one`, one
host read per step. The steps are not captured in a CUDA graph.

**Device prefetch.** `DL4J_TPU_DEVICE_PREFETCH` on: `device_prefetch_place
(device)` is the placer an AsyncDataSetIterator's producer runs. On a card
it copies each array into pinned host memory, then to the card with
`non_blocking=True` on a side stream owned by the producer, and records an
event; the consumer (`datasets.iterators.arrive`) makes its current stream
wait on the event and calls `record_stream` on each tensor before the
batch is used, so no step reads a half-copied batch and the allocator
does not hand the buffers out again while the step still reads them.

**TrainingRun** owns the lifecycle of one fit() call:

  - resume and save cadence: `checkpoint_manager=` (a
    resilience.CheckpointManager, the one keyword every fit forwards here
    through `**attachments`) restores the newest valid checkpoint at
    construction, before any step, and writes one at each epoch end;
    `epochs` is the TOTAL target, so a run stopped after epoch 2 of
    epochs=4 resumes and trains exactly 2 more. A state whose score is
    not finite is never checkpointed;
  - the listeners' order: `on_fit_start`, then `on_epoch_start` /
    `on_epoch_end` around each epoch (`model.epoch` advances after
    `on_epoch_end`, before the save), `iteration_done` from the steps,
    `on_fit_end` in the `finally` with `swallow=True`, so it fires when a
    step raises and a listener failing there is logged and does not mask
    the step's exception. Listeners that lack an epoch callback are
    skipped for it (every callback is optional);
  - a `cleanup` the facade passes (the prefetch producer it started is
    shut down whatever happens).

**Sharded carries.** Under ParallelWrapper's fsdp or model axis a
network's params live sharded at rest (`parallel.layout.FsdpArrangement`)
through a window's K steps: each step gathers on use and updates the
slices in place. `scan_carry_specs(model)` gives the placement a window
takes its params in (the sharded-at-rest specs) and the one the update
leaves them in (`extend(drop_fsdp(spec))` over the whole shape), per key;
the two agree for every layout `parallel.layout` makes, which is what
lets the K steps run on the slices.

The JAX engine's telemetry spans, step histograms, health beats, tuner
signals and flight records, `run_partition` and `master_session` are not
ported (ROADMAP A.11).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import fire_lifecycle
from deeplearning4j_tpu_torch.util import envflags

_WINDOW_GATE = "DL4J_TPU_STEP_WINDOW"
_PREFETCH_GATE = "DL4J_TPU_DEVICE_PREFETCH"

_ATTACHMENTS = ("checkpoint_manager",)


def window_size(default: int = 1) -> int:
    """Steps rolled into one window (`DL4J_TPU_STEP_WINDOW`): 1 (the
    default, unset or unparsable) is the per-step loop."""
    return max(1, envflags.int_value(_WINDOW_GATE, default))


def scan_carry_specs(model):
    """(in_specs, out_specs) of a window's param carry, {key: {path: spec
    tuple}}, or None when the model carries no sharded layout: the
    sharded-at-rest specs a window starts from, and where the layout
    would place the updated params, `extend(drop_fsdp(spec))` over each
    param's whole interchange shape."""
    from deeplearning4j_tpu_torch.parallel import layout as layout_mod

    arr = model._shard_layout
    params = model.params
    if arr is None or not params:
        return None
    layout = arr.layout
    sizes = arr.mesh.shape
    fsdp_size = sizes.get(layout.fsdp_axis, 1)
    in_specs, out_specs = {}, {}
    for key, spec_tree in arr.specs.items():
        if key not in params:
            continue
        in_specs[key] = spec_tree
        out_specs[key] = {}
        for path, spec in spec_tree.items():
            pl = arr.placement(key, path)
            t = layout_mod.mesh_mod.leaf_at(params[key], path)
            shape = []
            for i in range(t.dim()):
                d = i if pl.dims is None else pl.dims[i]
                axis = spec[i] if i < len(spec) else None
                shape.append(t.shape[d] * (sizes[axis] if axis else 1))
            out_specs[key][path] = layout.extend(
                layout.drop_fsdp(spec), tuple(shape), fsdp_size)
    return in_specs, out_specs


def place_batch(ds, put: Callable):
    """`put` applied to every array of a DataSet or MultiDataSet (masks
    included, None passed through); any other value is `put` itself."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

    def p(a):
        return None if a is None else put(a)

    if isinstance(ds, DataSet):
        return DataSet(p(ds.features), p(ds.labels),
                       p(ds.features_mask), p(ds.labels_mask))
    if isinstance(ds, MultiDataSet):
        return MultiDataSet(
            [p(f) for f in ds.features], [p(l) for l in ds.labels],
            ([p(m) for m in ds.features_masks]
             if ds.features_masks is not None else None),
            ([p(m) for m in ds.labels_masks]
             if ds.labels_masks is not None else None))
    return put(ds)


def batch_tensors(ds) -> List[torch.Tensor]:
    """The tensors of a DataSet or MultiDataSet (None skipped)."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    if isinstance(ds, MultiDataSet):
        arrays = list(ds.features) + list(ds.labels) + list(
            ds.features_masks or []) + list(ds.labels_masks or [])
    else:
        arrays = [ds.features, ds.labels, ds.features_mask, ds.labels_mask]
    return [a for a in arrays if isinstance(a, torch.Tensor)]


def to_device_async(device) -> Callable:
    """A placer (DataSet -> DataSet) copying every array to `device`. On a
    CUDA device: each array through pinned host memory onto the card with
    `non_blocking=True`, on a side stream the placer owns, then an event;
    the result carries `on_arrival`, which the consumer calls before it
    uses the batch (`datasets.iterators.arrive`): its current stream waits
    on the event and every tensor is `record_stream`-ed on it. On the CPU:
    each array as a tensor, no arrival hook."""
    from deeplearning4j_tpu_torch.models._training import as_tensor

    device = torch.device(device)
    if device.type != "cuda":
        return lambda ds: place_batch(ds, lambda a: as_tensor(a).to(device))
    side = []

    def put(a):
        t = as_tensor(a)
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def place(ds):
        if not side:
            side.append(torch.cuda.Stream(device))
        stream = side[0]
        with torch.cuda.stream(stream):
            out = place_batch(ds, put)
            ready = torch.cuda.Event()
            ready.record(stream)
        tensors = batch_tensors(out)

        def on_arrival():
            cur = torch.cuda.current_stream(device)
            cur.wait_event(ready)
            for t in tensors:
                t.record_stream(cur)

        out.on_arrival = on_arrival
        return out

    return place


def device_prefetch_place(device=None) -> Optional[Callable]:
    """The producer-side placer of `DL4J_TPU_DEVICE_PREFETCH` (default
    off: None, batches stay on the host until the step copies them):
    `to_device_async(device)`, `device` defaulting to the card."""
    if not envflags.enabled(_PREFETCH_GATE, False):
        return None
    from deeplearning4j_tpu_torch import device as device_mod

    return to_device_async(device_mod.resolve(device))


def _signature(args) -> tuple:
    """A hashable key of a staged batch: its structure with each tensor's
    shape and dtype and each None in place. Batches window together only
    when their keys are equal."""
    if isinstance(args, (list, tuple)):
        return (type(args).__name__,) + tuple(_signature(a) for a in args)
    if isinstance(args, torch.Tensor):
        return (tuple(args.shape), str(args.dtype), str(args.device))
    return (args if args is None or isinstance(args, (int, float, str))
            else type(args).__name__)


class WindowedFitLoop:
    """The inner epoch loop every fit path shares (the JAX package's).

      exec_one(ds)      the path's own step on one batch (listeners fired
                        inside): the K = 1 path and the fallback for
                        batches `stage` refuses.
      stage(ds)         -> (args, report_batch): the step's arguments on
                        the device and the rows the step reports; None
                        routes the batch through `exec_one` after the
                        pending window.
      raw_step(*args, iteration=it)
                        the device step on staged args at iteration `it`:
                        returns the score as a 0-d device tensor and
                        leaves the bookkeeping to the loop.
    """

    def __init__(self, model, *, raw_step: Callable, stage: Callable,
                 exec_one: Callable):
        self.model = model
        self.window = window_size()
        self.raw_step = raw_step
        self.stage = stage
        self.exec_one = exec_one
        self._buf: List[Tuple[tuple, int]] = []
        self._buf_sig = None

    def run_epoch(self, batches) -> None:
        """One pass over `batches`; the pending window flushes before it
        returns, so epoch-end hooks see every step applied. An exception
        from the iterator or a step drops the staged batches (never
        applied: a resumed fit replays the epoch from its checkpoint)."""
        try:
            for ds in batches:
                self._consume(ds)
        except BaseException:
            self._buf = []
            raise
        self.flush()

    def _consume(self, ds) -> None:
        if self.window == 1:
            self.exec_one(ds)
            return
        staged = self.stage(ds)
        if staged is None:
            # a batch of its own kind: apply the pending window first, so
            # the steps keep their order
            self.flush()
            self.exec_one(ds)
            return
        args, report_batch = staged
        sig = _signature(args)
        if self._buf and sig != self._buf_sig:
            self.flush()
        self._buf.append((args, report_batch))
        self._buf_sig = sig
        if len(self._buf) >= self.window:
            self.flush()

    def flush(self) -> None:
        """Run the pending window (a no-op when empty): `on_window_start`,
        the steps, one read of their scores, the replay, `on_window_end`.
        A window shorter than K (the epoch's tail, a change of signature)
        runs at its own length."""
        if not self._buf:
            return
        batch, self._buf = self._buf, []
        m = self.model
        for lst in m.listeners:
            cb = getattr(lst, "on_window_start", None)
            if cb is not None:
                cb(m)
        it0 = m.iteration
        scores = [self.raw_step(*args, iteration=it0 + j)
                  for j, (args, _) in enumerate(batch)]
        # the window's one host read
        host = torch.stack(scores).cpu().tolist()
        # during the replay the params are the window's end while
        # `iteration` walks through the steps: listeners that persist
        # (iteration, params) pairs defer to on_window_end
        m._window_replay = True
        try:
            expected = m.iteration
            for (_, rows), s in zip(batch, host):
                m.score_ = float(s)
                m.last_batch_size = rows
                m.iteration += 1
                expected += 1
                for lst in m.listeners:
                    lst.iteration_done(m, m.iteration, m.score_)
                if m.iteration != expected:
                    # a listener rewound the network (a rollback): the
                    # remaining scores are of discarded steps
                    break
        finally:
            m._window_replay = False
        for lst in m.listeners:
            cb = getattr(lst, "on_window_end", None)
            if cb is not None:
                cb(m)


def _fire_epoch(listeners, event: str, model) -> None:
    for lst in listeners:
        cb = getattr(lst, event, None)
        if cb is not None:
            cb(model, model.epoch)


class TrainingRun:
    """The fit lifecycle of one fit() call (see the module docstring)."""

    def __init__(self, model, *, epochs: int = 1, **attachments):
        unknown = sorted(set(attachments) - set(_ATTACHMENTS))
        if unknown:
            raise TypeError(
                f"fit() got unexpected keyword argument(s): {unknown}; "
                f"engine attachments are {list(_ATTACHMENTS)}")
        self.model = model
        self.manager = attachments.get("checkpoint_manager")
        if self.manager is not None:
            self.manager.restore_into(model)
            epochs = max(0, epochs - model.epoch)
        self.epochs = epochs

    def save_epoch(self) -> None:
        """Epoch-end checkpoint (a no-op without a manager)."""
        if self.manager is not None and np.isfinite(self.model.score_):
            self.manager.save(self.model, extra={"trigger": "epoch"})

    def execute(self, run_epoch: Callable, batches, *,
                cleanup: Optional[Callable] = None):
        """Run the fit: `run_epoch` trains one pass of `batches` (a
        WindowedFitLoop's `run_epoch`, or a function around one),
        `batches` the epoch's iterable or a zero-argument callable that
        makes one per epoch. Returns the model."""
        m = self.model
        fire_lifecycle(m.listeners, "on_fit_start", m)
        try:
            for _ in range(self.epochs):
                _fire_epoch(m.listeners, "on_epoch_start", m)
                run_epoch(batches() if callable(batches) else batches)
                _fire_epoch(m.listeners, "on_epoch_end", m)
                m.epoch += 1
                self.save_epoch()
        finally:
            if cleanup is not None:
                cleanup()
            fire_lifecycle(m.listeners, "on_fit_end", m, swallow=True)
        return m
