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

**Telemetry** (the JAX engine's, under `DL4J_TPU_TELEMETRY`): each epoch
runs under a fit-level TraceContext (one trace id for every span of the
fit, unless the caller already attached one); the wait for each batch is
an "etl" span (category "data") and sets `model.last_etl_time_ms`, which
PerformanceListener and StatsListener read; each step is a "step" span
under the loop's `span_category` ("train", "collective" under
ParallelWrapper) and one `dl4j_tpu_step_seconds` observation (a window of
K records elapsed / K per step); the stall watchdog's heartbeat
(`telemetry.health.fit_health`) beats after every dispatch and before each
window; a failing fit writes `flight.record_crash` with the fit's phase.
With the gate off none of this allocates.

Still missing (ROADMAP A.11): the per-fit introspection (item 3:
`introspect.fit_introspection`, the HBM watermark), the closed-loop
tuner's epoch ticks and window signals (item 4: with `DL4J_TPU_AUTOTUNE`
on a fit raises NotImplementedError; off, nothing happens, as in JAX),
`run_partition` and `master_session` (item 5).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import fire_lifecycle
from deeplearning4j_tpu_torch.telemetry import context as context_mod
from deeplearning4j_tpu_torch.telemetry import health as health_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util import envflags

_WINDOW_GATE = "DL4J_TPU_STEP_WINDOW"
_PREFETCH_GATE = "DL4J_TPU_DEVICE_PREFETCH"
AUTOTUNE_GATE = "DL4J_TPU_AUTOTUNE"

_ATTACHMENTS = ("checkpoint_manager",)

_STEP_SECONDS = None


def _step_hist():
    """``dl4j_tpu_step_seconds``, the per-step wall time (the SLO engine's
    step-time objective reads it). Created on first use and observed only
    while telemetry is on."""
    global _STEP_SECONDS
    if _STEP_SECONDS is None:
        from deeplearning4j_tpu_torch.telemetry import metrics as metrics_mod

        _STEP_SECONDS = metrics_mod.histogram(
            "dl4j_tpu_step_seconds",
            "Optimizer step wall time (windowed dispatches record "
            "elapsed/n per step)",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
    return _STEP_SECONDS


def _check_tuner() -> None:
    """The JAX engine arms the closed-loop tuner here (epoch ticks,
    `tuning_signals`) while ``DL4J_TPU_AUTOTUNE`` is on; the tuner is not
    ported yet, so the gate on raises instead of training untuned."""
    if envflags.enabled(AUTOTUNE_GATE, False):
        raise NotImplementedError(
            f"{AUTOTUNE_GATE} is on, but the closed-loop tuner "
            f"(telemetry/tuner.py and tuning/*, with the knob registry) is "
            f"not ported yet (ROADMAP A.11 item 4); unset the gate")


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
      on_dispatch()     optional hook run just before a window's steps
                        (ParallelWrapper's chaos `collective` site).
      span_category     the category of the "step" spans.

    `health` is the stall watchdog's heartbeat handle, which
    `TrainingRun.execute` binds for the fit (`NULL_HEALTH` otherwise).
    """

    def __init__(self, model, *, raw_step: Callable, stage: Callable,
                 exec_one: Callable, on_dispatch: Optional[Callable] = None,
                 span_category: str = "train"):
        self.model = model
        self.window = window_size()
        self.raw_step = raw_step
        self.stage = stage
        self.exec_one = exec_one
        self.on_dispatch = on_dispatch
        self.span_category = span_category
        self.health = health_mod.NULL_HEALTH
        self._buf: List[Tuple[tuple, int]] = []
        self._buf_sig = None

    def run_epoch(self, batches) -> None:
        """One pass over `batches`; the pending window flushes before it
        returns, so epoch-end hooks see every step applied. An exception
        from the iterator or a step drops the staged batches (never
        applied: a resumed fit replays the epoch from its checkpoint).
        The spans land under TrainingRun.execute's fit-level
        TraceContext."""
        tr = trace_mod.tracer()
        t0 = time.perf_counter()
        try:
            for ds in batches:
                etl_ms = (time.perf_counter() - t0) * 1e3
                self.model.last_etl_time_ms = etl_ms
                if tr.enabled:
                    tr.add_span("etl", etl_ms, category="data")
                self._consume(ds, tr)
                t0 = time.perf_counter()
        except BaseException:
            self._buf = []
            raise
        self.flush(tr)

    def _consume(self, ds, tr) -> None:
        if self.window == 1:
            self._exec_one(ds, tr)
            return
        staged = self.stage(ds)
        if staged is None:
            # a batch of its own kind: apply the pending window first, so
            # the steps keep their order
            self.flush(tr)
            self._exec_one(ds, tr)
            return
        args, report_batch = staged
        sig = _signature(args)
        if self._buf and sig != self._buf_sig:
            self.flush(tr)
        self._buf.append((args, report_batch))
        self._buf_sig = sig
        if len(self._buf) >= self.window:
            self.flush(tr)

    def _exec_one(self, ds, tr) -> None:
        t_step = time.perf_counter()
        with tr.span("step", category=self.span_category):
            self.exec_one(ds)
        if tr.enabled:
            _step_hist().observe(time.perf_counter() - t_step)
        self.health.beat(self.model.iteration)

    def flush(self, tr=None) -> None:
        """Run the pending window (a no-op when empty): `on_window_start`,
        the steps, one read of their scores, the replay, `on_window_end`.
        A window shorter than K (the epoch's tail, a change of signature)
        runs at its own length."""
        if not self._buf:
            return
        if tr is None:
            tr = trace_mod.tracer()
        batch, self._buf = self._buf, []
        n = len(batch)
        m = self.model
        for lst in m.listeners:
            cb = getattr(lst, "on_window_start", None)
            if cb is not None:
                cb(m)
        # beat before the window, as the JAX engine does before its scan
        self.health.beat(m.iteration)
        if self.on_dispatch is not None:
            self.on_dispatch()
        it0 = m.iteration
        t_step = time.perf_counter()
        scores = [self.raw_step(*args, iteration=it0 + j)
                  for j, (args, _) in enumerate(batch)]
        # the window's one host read
        host = torch.stack(scores).cpu().tolist()
        elapsed = time.perf_counter() - t_step
        if tr.enabled:
            # n per-step spans of elapsed / n, so step-span medians stay
            # per-step comparable
            per_step_ms = elapsed * 1e3 / n
            hist = _step_hist()
            for _ in range(n):
                tr.add_span("step", per_step_ms, category=self.span_category)
                hist.observe(per_step_ms / 1e3)
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
        self.health.beat(m.iteration)


def _fire_epoch(listeners, event: str, model) -> None:
    for lst in listeners:
        cb = getattr(lst, event, None)
        if cb is not None:
            cb(model, model.epoch)


class TrainingRun:
    """The fit lifecycle of one fit() call (see the module docstring);
    `phase` names the fit path in heartbeats and crash bundles
    ("MultiLayerNetwork.fit", "ComputationGraph.fit",
    "ParallelWrapper.fit")."""

    def __init__(self, model, phase: str = "fit", *, epochs: int = 1,
                 **attachments):
        unknown = sorted(set(attachments) - set(_ATTACHMENTS))
        if unknown:
            raise TypeError(
                f"fit() got unexpected keyword argument(s): {unknown}; "
                f"engine attachments are {list(_ATTACHMENTS)}")
        self.model = model
        self.phase = phase
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
                loop: Optional[WindowedFitLoop] = None,
                cleanup: Optional[Callable] = None):
        """Run the fit: `run_epoch` trains one pass of `batches` (a
        WindowedFitLoop's `run_epoch`, or a function around one),
        `batches` the epoch's iterable or a zero-argument callable that
        makes one per epoch; `loop` gets the fit's heartbeat handle.
        Returns the model."""
        from deeplearning4j_tpu_torch.telemetry import flight as flight_mod

        _check_tuner()
        m = self.model
        hb = health_mod.fit_health(self.phase)
        if loop is not None:
            loop.health = hb
        # attached outside the crash guard, so the crash bundle stamps the
        # fit's trace id
        ctx_token = (context_mod.attach(context_mod.new_trace())
                     if trace_mod.tracer().enabled
                     and context_mod.current() is None else None)
        fire_lifecycle(m.listeners, "on_fit_start", m)
        try:
            for _ in range(self.epochs):
                _fire_epoch(m.listeners, "on_epoch_start", m)
                run_epoch(batches() if callable(batches) else batches)
                _fire_epoch(m.listeners, "on_epoch_end", m)
                m.epoch += 1
                self.save_epoch()
        except BaseException as e:
            # the black box, while the dying state is still there (a no-op
            # with telemetry off; never raises)
            flight_mod.record_crash(e, model=m,
                                    checkpoint_manager=self.manager,
                                    phase=self.phase)
            raise
        finally:
            if cleanup is not None:
                cleanup()
            hb.end()
            if loop is not None:
                loop.health = health_mod.NULL_HEALTH
            fire_lifecycle(m.listeners, "on_fit_end", m, swallow=True)
            if ctx_token is not None:
                context_mod.detach(ctx_token)
        return m
