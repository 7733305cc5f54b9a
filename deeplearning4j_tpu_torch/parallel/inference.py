"""ParallelInference — inference server with dynamic batching
(counterpart of deeplearning4j_tpu/parallel/inference.py; the reference's
parallelism/ParallelInference.java: INSTANT mode dispatches each request
at once, BATCHED mode coalesces requests up to `batch_limit`).

One background dispatcher thread owns the device. Two dispatchers behind
one API:

  * With the `DL4J_TPU_SERVING` gate ON, construction routes through the
    overload-hardened serving runtime (serving/runtime.py
    InferenceServer): bucketed padded shapes, admission control with
    per-request deadlines, a bounded queue with load shedding, circuit
    breaking, drain on shutdown. `output(x, deadline_s=...)` raises the
    typed serving errors on refusal.
  * With the gate OFF (default) the light dispatcher runs: no buckets,
    no breaker, and the runtime module is not even imported. Its
    liveness rules are the JAX package's: the queue drains on shutdown
    and every pending request resolves with a typed error
    (ShutdownError / DispatcherCrashedError), `output()` waits in bounded
    slices keyed to an optional deadline, coalescing never overshoots
    `batch_limit` (an oversize request dispatches alone), and requests
    coalesce only with a matching trailing shape and dtype, so a
    mismatched input is carried into the next batch and fails alone.

Where it runs. With `mesh=None` the model is served on its own device
(one card, batches padded to a multiple of 1). On a `parallel.mesh.Grid`
of more than one rank, the JAX package's single-controller sharded
forward (the batch placed with P("data") and one jitted forward over the
mesh) becomes rank-0 dispatch:

  * rank 0 broadcasts each batch, padded to a multiple of the data axis,
    to every rank of the grid (a shape header, then the tensor);
  * each rank runs `model.output` on its data coordinate's rows (the
    rows are replicated over the other axes, as P("data") replicates
    them: a dcn row computes what its data peers compute);
  * all_gather over the data axis returns the rows, and rank 0 trims the
    padding;
  * the other ranks serve in `follow()` until rank 0's `shutdown()`
    sends the stop message, after the batch in flight (GridDispatch).

Every rank builds the same ParallelInference; rank 0 takes requests:

    pi = ParallelInference(net, mesh=grid)
    if grid.rank == 0:
        out = pi.output(x)
        pi.shutdown()
    else:
        pi.follow()

A batch that fails on any rank fails on rank 0 and every rank goes on
serving.

Telemetry, as in the JAX module: with ``DL4J_TPU_TELEMETRY`` on, the light
dispatcher gives each request a TraceContext, a flow arrow from the
caller to its batch, an ``inference.resolve`` span around the caller's
wait and an ``inference.dispatch`` span per member on the dispatcher's
named lane.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.retry import Deadline
from deeplearning4j_tpu_torch.serving import SERVING_GATE
from deeplearning4j_tpu_torch.serving.buckets import signature as _sig
from deeplearning4j_tpu_torch.serving.errors import (
    DeadlineExceededError,
    DispatcherCrashedError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.telemetry import context as context_mod
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.util import envflags

logger = logging.getLogger("deeplearning4j_tpu_torch")

# the header of a grid dispatch: code (1 a batch, 0 stop), dtype, ndim
# and up to 9 dims
_HEAD = 12
_STOP, _BATCH = 0, 1
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)


def _leader(grid) -> bool:
    return grid is None or grid.rank == 0


def _model_device(model) -> torch.device:
    return getattr(model, "device", torch.device("cpu"))


def _broadcast_head(grid, code: int, x: Optional[torch.Tensor], device):
    head = torch.zeros(_HEAD, dtype=torch.int64)
    head[0] = code
    if x is not None:
        if x.dim() > _HEAD - 3:
            raise ValueError(f"a batch of {x.dim()} dims: the grid "
                             f"dispatch carries at most {_HEAD - 3}")
        head[1] = _DTYPES.index(x.dtype)
        head[2] = x.dim()
        head[3:3 + x.dim()] = torch.tensor(x.shape)
    head = head.to(device)
    torch.distributed.broadcast(head, 0, group=grid.group)
    return head.cpu()


def _forward_rows(model, grid, x: torch.Tensor):
    """Every rank: `model.output` on its data coordinate's rows of the
    padded batch `x`, the rows joined over the data axis. A failure on any
    rank is agreed on first (one all_reduce), so the gather never meets a
    rank that has nothing to send; rank 0 raises it."""
    data = grid.data
    per = x.shape[0] // data.size
    err, out = None, None
    try:
        out = model.output(x[data.rank * per:(data.rank + 1) * per])
        out = torch.as_tensor(out).detach()
    except Exception as e:  # agreed on below, raised on rank 0
        err = e
    failed = torch.tensor([0.0 if err is None else 1.0], device=x.device)
    torch.distributed.all_reduce(failed, op=torch.distributed.ReduceOp.MAX,
                                 group=grid.group)
    if float(failed) > 0:
        if err is None:
            err = RuntimeError("the batch failed on another rank of the "
                               "grid")
        if _leader(grid):
            raise err
        logger.warning("grid dispatch: a batch failed on this rank (%r)",
                       err)
        return None
    return data.all_gather(out.contiguous(), 0)


class GridDispatch:
    """Rank 0's dispatch of a padded batch (numpy or tensor, rows a
    multiple of the grid's data axis) over `grid`: broadcast, every rank's
    rows through `model.output`, the rows gathered. Without a grid or on
    one of one rank it is `model.output` (looked up at each call).

    A batch's collectives and the stop message are sequences on one
    process group that must not interleave, so both run under one lock,
    whichever thread calls them: `stop()` waits for a batch in flight.
    After the stop a dispatch raises ShutdownError."""

    def __init__(self, model, grid):
        self.model = model
        self.grid = grid
        self._device = _model_device(model)
        self._lock = threading.Lock()
        self._stopped = False

    def _multi(self) -> bool:
        return self.grid is not None and self.grid.size > 1

    def __call__(self, xp):
        if not self._multi():
            return self.model.output(xp)
        grid = self.grid
        x = torch.as_tensor(np.ascontiguousarray(xp)
                            if isinstance(xp, np.ndarray) else xp)
        if x.shape[0] % grid.data.size:
            raise ValueError(f"a batch of {x.shape[0]} rows over "
                             f"{grid.data.size} data ranks")
        x = x.to(self._device).contiguous()
        with self._lock:
            if self._stopped:
                raise ShutdownError("the grid's other ranks were stopped")
            _broadcast_head(grid, _BATCH, x, self._device)
            torch.distributed.broadcast(x, 0, group=grid.group)
            return _forward_rows(self.model, grid, x)

    def stop(self) -> None:
        """The stop message that ends every other rank's `follow`, sent
        once, after the batch in flight (each of its collectives waits at
        most the process group's timeout)."""
        if not self._multi():
            return
        with self._lock:
            if not self._stopped:
                self._stopped = True
                _broadcast_head(self.grid, _STOP, None, self._device)


def follow(model, grid) -> int:
    """A rank other than 0: serves rank 0's grid dispatches of `model`
    until its stop message; returns the batches served. Each collective
    waits at most the process group's timeout."""
    device = _model_device(model)
    served = 0
    while True:
        head = torch.empty(_HEAD, dtype=torch.int64, device=device)
        torch.distributed.broadcast(head, 0, group=grid.group)
        head = head.cpu()
        if int(head[0]) == _STOP:
            return served
        shape = tuple(int(v) for v in head[3:3 + int(head[2])])
        x = torch.empty(shape, dtype=_DTYPES[int(head[1])], device=device)
        torch.distributed.broadcast(x, 0, group=grid.group)
        _forward_rows(model, grid, x)
        served += 1


class _Request:
    def __init__(self, x, deadline: Optional[Deadline] = None):
        self.x = x
        self.deadline = deadline or Deadline(None)
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # per-request TraceContext while telemetry is on (None otherwise);
        # the dispatcher attaches it so the dispatch span joins the
        # request's trace across the thread handoff
        self.ctx = None


def _to_host(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()
    return np.asarray(out)


class ParallelInference:
    INSTANT = "instant"
    BATCHED = "batched"

    def __init__(self, model, mesh=None, mode: str = "batched",
                 batch_limit: int = 32, queue_limit: int = 64,
                 wait_ms: float = 2.0, workers: Optional[int] = None):
        """`model`: anything with `output(x)` (a port network on its
        device). `mesh`: None (the model's own device) or a Grid (see the
        module docstring). `workers` is the JAX signature's device count:
        without a mesh it must be None or 1; a multi-rank run passes its
        Grid."""
        if mesh is None and workers not in (None, 1):
            raise ValueError(
                f"workers={workers}: build a grid of that many ranks "
                f"(parallel.mesh.build_mesh) and pass it as mesh=")
        self.model = model
        self.mesh = mesh
        self.mode = mode
        self.batch_limit = batch_limit
        self.wait_ms = wait_ms
        self._serving = None
        self._align = 1 if mesh is None else mesh.shape["data"]
        if not _leader(mesh):
            return  # a follower: follow() serves rank 0's batches
        if envflags.enabled(SERVING_GATE, False):
            # the serving runtime owns everything from here; imported
            # only on this branch, so the gate-off path allocates none of
            # its state
            from deeplearning4j_tpu_torch.serving.runtime import (
                InferenceServer,
            )

            self._serving = InferenceServer(
                model=model, mesh=mesh, batch_limit=batch_limit,
                queue_limit=queue_limit,
                wait_ms=(0.0 if mode == self.INSTANT else wait_ms),
                name="ParallelInference")
            return
        self._dispatch = GridDispatch(model, mesh)
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_limit)
        self._carry: Optional[_Request] = None
        self._crash: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True,
                                        name="ParallelInference-dispatch")
        self._thread.start()

    # ------------------------------------------------------------------
    def output(self, x, deadline_s: Optional[float] = None) -> np.ndarray:
        """Blocking inference call, thread-safe (the reference's
        ParallelInference.output). `deadline_s` bounds the WHOLE call;
        on expiry DeadlineExceededError is raised instead of waiting
        further. Even without a deadline the wait is sliced: a dead or
        shut-down dispatcher surfaces as a typed error, never a hang."""
        if not _leader(self.mesh):
            raise RuntimeError(f"rank {self.mesh.rank} follows rank 0: "
                               f"send requests to rank 0, call follow() "
                               f"here")
        if self._serving is not None:
            return self._serving.output(x, deadline_s=deadline_s)
        self._check_live()
        deadline = Deadline(deadline_s)
        req = _Request(np.asarray(x), deadline)
        tr = trace_mod.tracer()
        if not tr.enabled:
            return self._await(req, deadline)
        req.ctx = context_mod.new_trace()
        with context_mod.activate(req.ctx):
            t0 = time.perf_counter()
            outcome = "ok"
            try:
                tr.add_flow("inference.batch", flow_id=req.ctx.trace_id,
                            phase="s", category="serving")
                return self._await(req, deadline)
            except BaseException as e:
                outcome = type(e).__name__
                raise
            finally:
                tr.add_span("inference.resolve",
                            (time.perf_counter() - t0) * 1e3,
                            category="serving", outcome=outcome)

    def follow(self) -> int:
        """On a rank other than 0: serve rank 0's batches until its
        shutdown; returns the batches served."""
        if _leader(self.mesh):
            raise RuntimeError("rank 0 dispatches; follow() runs on the "
                               "other ranks of the grid")
        return follow(self.model, self.mesh)

    def _await(self, req: _Request, deadline: Deadline) -> np.ndarray:
        while True:  # bounded enqueue: a full queue must not park us past
            self._check_live()  # the deadline or a dispatcher death
            if deadline.expired:
                raise DeadlineExceededError(
                    f"deadline {deadline.seconds:.3g}s expired while "
                    f"waiting for queue space")
            try:
                self._q.put(req, timeout=0.05)
                break
            except queue.Full:
                continue
        while not req.event.wait(0.05):
            if req.event.is_set():
                break
            if deadline.expired:
                raise DeadlineExceededError(
                    f"deadline {deadline.seconds:.3g}s expired awaiting "
                    f"dispatch")
            if self._crash is not None:
                raise DispatcherCrashedError(
                    f"inference dispatcher died: {self._crash!r}",
                    cause=self._crash)
            if not self._thread.is_alive():
                # drain resolves queued requests; this catches a request
                # racing a death that never reached the drain
                raise DispatcherCrashedError(
                    "inference dispatcher thread is dead")
        if req.error is not None:
            raise req.error
        return req.result

    def _check_live(self) -> None:
        if self._crash is not None:
            raise DispatcherCrashedError(
                f"inference dispatcher died: {self._crash!r}",
                cause=self._crash)
        if self._stop.is_set():
            raise ShutdownError("ParallelInference is shut down")

    def shutdown(self, timeout: float = 5.0):
        """Stop the dispatcher AND drain: every queued request resolves
        with ShutdownError — no caller is left parked on a dead queue.
        The wait for the dispatcher is bounded by `timeout`. On rank 0 of
        a grid, then the stop message to the other ranks, after the batch
        in flight. On a follower, nothing (its follow() ends on rank 0's
        stop)."""
        if not _leader(self.mesh):
            return
        if self._serving is not None:
            self._serving.shutdown(timeout=timeout)  # it stops the grid
            return
        self._stop.set()
        dl = Deadline(timeout)
        while self._thread.is_alive() and not dl.expired:
            self._thread.join(0.1)
        # belt: the loop's exit path drains too, but a thread that died
        # before setting _crash (or a request enqueued mid-stop) must
        # still resolve
        self._drain(ShutdownError("ParallelInference is shut down"))
        self._dispatch.stop()

    # ------------------------------------------------------------------
    def _take_next(self, timeout: float) -> Optional[_Request]:
        """Next live request (carry slot first). A request whose deadline
        already expired is resolved here and never dispatched: its caller
        raised and walked away."""
        while True:
            if self._carry is not None:
                nxt, self._carry = self._carry, None
            else:
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    return None
            if not nxt.deadline.expired:
                return nxt
            nxt.error = DeadlineExceededError(
                f"deadline {nxt.deadline.seconds:.3g}s expired in queue")
            nxt.event.set()
            timeout = 0.0  # expired ones are free; don't re-wait

    def _drain(self, error: BaseException) -> None:
        if self._carry is not None:
            self._carry.error = error
            self._carry.event.set()
            self._carry = None
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.error = error
            r.event.set()

    def _dispatch_loop(self):
        tr = trace_mod.tracer()
        if tr.enabled:  # name the lane so Chrome/Perfetto shows it
            tr.set_thread_name(threading.get_ident(),
                               "ParallelInference-dispatch")
        try:
            self._pump()
        except BaseException as e:  # surface to callers, never vanish
            self._crash = e
            logger.exception("ParallelInference dispatcher crashed")
            self._drain(DispatcherCrashedError(
                f"inference dispatcher died: {e!r}", cause=e))
        else:
            self._drain(ShutdownError("ParallelInference is shut down"))

    def _pump(self):
        while not self._stop.is_set():
            first = self._take_next(timeout=0.1)
            if first is None:
                continue
            batch = [first]
            total = first.x.shape[0]
            sig = _sig(first.x)
            if self.mode == self.BATCHED:
                wait = self.wait_ms / 1000.0
                # never overshoot batch_limit: a request that would is
                # carried into the NEXT batch (an oversize single request
                # dispatches alone). A mismatched trailing shape/dtype also
                # carries: it must fail alone, not poison this batch.
                while total < self.batch_limit:
                    nxt = self._take_next(timeout=wait)
                    if nxt is None:
                        break
                    if (_sig(nxt.x) != sig
                            or total + nxt.x.shape[0] > self.batch_limit):
                        self._carry = nxt
                        break
                    batch.append(nxt)
                    total += nxt.x.shape[0]
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]):
        t0 = time.perf_counter()
        try:
            sizes = [r.x.shape[0] for r in batch]
            x = (np.concatenate([r.x for r in batch], axis=0)
                 if len(batch) > 1 else batch[0].x)
            pad = (-x.shape[0]) % self._align
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)],
                                   axis=0)
            out = _to_host(self._dispatch(x))  # one host copy per batch
            if pad:
                out = out[: out.shape[0] - pad]
            off = 0
            for r, s in zip(batch, sizes):
                r.result = out[off:off + s]
                off += s
                r.event.set()
            self._trace_batch(batch, (time.perf_counter() - t0) * 1e3, "ok")
        except BaseException as e:
            self._trace_batch(batch, (time.perf_counter() - t0) * 1e3,
                              type(e).__name__)
            for r in batch:
                r.error = e
                r.event.set()

    def _trace_batch(self, batch: List[_Request], dt_ms: float,
                     outcome: str) -> None:
        """Per-member dispatch spans on the dispatcher lane, each stamped
        with its request's trace ids; the flow finish binds the span back
        to the caller-side `inference.batch` arrow started in output()."""
        tr = trace_mod.tracer()
        if not tr.enabled:
            return
        for r in batch:
            if r.ctx is None:
                continue
            with context_mod.activate(r.ctx):
                tr.add_flow("inference.batch", flow_id=r.ctx.trace_id,
                            phase="f", category="serving")
                tr.add_span("inference.dispatch", dt_ms, category="serving",
                            rows=r.x.shape[0], batch_size=len(batch),
                            outcome=outcome)
