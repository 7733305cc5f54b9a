"""Training listener SPI + standard listeners (counterpart of
deeplearning4j_tpu/optimize/listeners.py).

Reference: optimize/api/{IterationListener,TrainingListener}.java and
optimize/listeners/ — ScoreIterationListener, PerformanceListener.java:19-23
(samples/sec, batches/sec, ETL time), CollectScoresIterationListener,
TimeIterationListener, EvaluativeListener.

The port's runtimes fire the same events in the same order as the JAX
package's (training/engine.py `TrainingRun`): `on_fit_start`, then
`on_epoch_start` / `on_epoch_end` around each epoch, `iteration_done` after
every step (every tBPTT window), `on_fit_end` in the `finally`. The
parameter statistics read the port's tensors (a copy to the host per
logged iteration); `ProfilerListener` traces with `torch.profiler`.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """All callbacks optional. `model` is the network facade; score is the
    python float of the last minibatch loss."""

    def iteration_done(self, model, iteration: int, score: float):
        pass

    def on_fit_start(self, model):
        """Fired once when a fit() call begins (before the first epoch) —
        MultiLayerNetwork.fit, ComputationGraph.fit, ParallelWrapper.fit."""
        pass

    def on_fit_end(self, model):
        """Fired once when the fit() call returns, INCLUDING on an
        exception escaping the training loop (try/finally in every fit
        path), so listeners holding open resources — profiler traces,
        file handles — can flush deterministically."""
        pass

    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_gradient_calculation(self, model):
        pass


def fire_lifecycle(listeners, event: str, model,
                   swallow: bool = False) -> None:
    """Invoke the optional `on_fit_start`/`on_fit_end` callback on every
    listener, tolerating duck-typed listeners that predate the lifecycle
    SPI (the contract is 'all callbacks optional' — a listener object
    implementing only iteration_done must keep working).

    swallow=True (the `finally`-path on_fit_end dispatch): a raising
    callback is logged, never propagated — the fit paths fire on_fit_end
    while a training exception (one a caller may resume from) may be in
    flight, and a listener's flush failure must not mask it from the
    code that resumes. Flush-on-teardown is best-effort by definition."""
    for lst in listeners:
        cb = getattr(lst, event, None)
        if cb is None:
            continue
        if not swallow:
            cb(model)
            continue
        try:
            cb(model)
        except Exception:
            logger.exception("listener %s.%s failed (ignored)",
                             type(lst).__name__, event)


class ScoreIterationListener(TrainingListener):
    """Log score every `frequency` iterations
    (optimize/listeners/ScoreIterationListener.java)."""

    def __init__(self, frequency: int = 10, print_fn: Optional[Callable] = None):
        self.frequency = max(1, frequency)
        self.print_fn = print_fn or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.print_fn(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """Throughput telemetry: samples/sec, batches/sec, iteration wall time,
    ETL (data-wait) time (PerformanceListener.java:19-23)."""

    def __init__(self, frequency: int = 10, report_etl: bool = True,
                 print_fn: Optional[Callable] = None):
        self.frequency = max(1, frequency)
        self.report_etl = report_etl
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self._last_time = None
        self.last_samples_per_sec = 0.0
        self.last_batches_per_sec = 0.0

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        if self._last_time is not None:
            dt = max(now - self._last_time, 1e-9)
            batch = getattr(model, "last_batch_size", None) or 0
            self.last_samples_per_sec = batch / dt
            self.last_batches_per_sec = 1.0 / dt
            if iteration % self.frequency == 0:
                etl = getattr(model, "last_etl_time_ms", 0.0)
                msg = (f"iteration {iteration}: {self.last_samples_per_sec:.1f} "
                       f"samples/sec, {self.last_batches_per_sec:.2f} batches/sec")
                if self.report_etl:
                    msg += f", ETL {etl:.1f} ms"
                self.print_fn(msg)
        self._last_time = now


class CollectScoresListener(TrainingListener):
    """Accumulate (iteration, score) pairs
    (optimize/listeners/CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, score))


class TimeIterationListener(TrainingListener):
    """ETA logging (optimize/listeners/TimeIterationListener.java)."""

    def __init__(self, iteration_count: int, frequency: int = 50,
                 print_fn: Optional[Callable] = None):
        self.iteration_count = iteration_count
        self.frequency = max(1, frequency)
        self.print_fn = print_fn or (lambda s: logger.info(s))
        # perf_counter, not time.time(): an NTP step mid-run would corrupt
        # the ETA (negative or wildly long estimates)
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self.start
            remaining = elapsed / iteration * (self.iteration_count - iteration)
            self.print_fn(f"Remaining time estimate: {remaining:.0f}s "
                          f"({iteration}/{self.iteration_count})")


class EvaluativeListener(TrainingListener):
    """Periodic evaluation against a held-out iterator
    (optimize/listeners/EvaluativeListener.java)."""

    def __init__(self, iterator, frequency: int = 100,
                 print_fn: Optional[Callable] = None):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self.last_evaluation = None

    def iteration_done(self, model, iteration, score):
        if iteration > 0 and iteration % self.frequency == 0:
            ev = model.evaluate(self.iterator)
            self.last_evaluation = ev
            self.print_fn(f"Evaluation at iteration {iteration}: "
                          f"accuracy={ev.accuracy():.4f} f1={ev.f1():.4f}")


class SleepyTrainingListener(TrainingListener):
    """Debug/throttle listener (optimize/listeners/SleepyTrainingListener.java)."""

    def __init__(self, sleep_ms: float = 0.0):
        self.sleep_ms = sleep_ms

    def iteration_done(self, model, iteration, score):
        if self.sleep_ms > 0:
            time.sleep(self.sleep_ms / 1000.0)


class ParamAndGradientIterationListener(TrainingListener):
    """Per-iteration parameter/update statistics to log or file
    (optimize/listeners/ParamAndGradientIterationListener.java: mean,
    min/max, mean-absolute of params and updates). The functional core
    applies updates inside the step, so the observable "gradient" here is
    the parameter delta between iterations — the same proxy the stats UI
    uses (update = lr-scaled gradient after clipping/normalization, the
    quantity the reference actually logs)."""

    def __init__(self, frequency: int = 1, print_mean: bool = True,
                 print_min_max: bool = True, print_mean_abs: bool = True,
                 output_file: Optional[str] = None):
        self.frequency = max(1, frequency)
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs = print_mean_abs
        self.output_file = output_file
        self._prev = None
        if output_file:
            with open(output_file, "w") as f:
                f.write("iteration,key,kind,mean,min,max,mean_abs\n")

    @staticmethod
    def _flat(params):
        """{"layer_0/W": numpy array} of a network's params, nested dicts
        joined by '/' (the JAX package's tree paths), copied to the
        host."""
        from deeplearning4j_tpu_torch.models._training import flat_items

        import torch

        # a copy: fit updates the params in place
        return {f"{k}/{path}": t.detach().to("cpu", torch.float32,
                                             copy=True).numpy()
                for k, p in params.items() for path, t in flat_items(p)}

    def _line(self, iteration, key, kind, arr):
        return ",".join([
            str(iteration), key, kind,
            f"{float(arr.mean()):.6g}" if self.print_mean else "",
            f"{float(arr.min()):.6g}" if self.print_min_max else "",
            f"{float(arr.max()):.6g}" if self.print_min_max else "",
            f"{float(np.abs(arr).mean()):.6g}"
            if self.print_mean_abs else ""])

    def iteration_done(self, model, iteration: int, score: float):
        if iteration % self.frequency:
            return
        flat = self._flat(model.params)
        lines = []
        for k, arr in flat.items():
            lines.append(self._line(iteration, k, "param", arr))
            if self._prev is not None and k in self._prev:
                lines.append(self._line(iteration, k, "update",
                                        arr - self._prev[k]))
        self._prev = flat
        if self.output_file:
            with open(self.output_file, "a") as f:  # one open per iteration
                f.write("\n".join(lines) + "\n")
        else:
            for line in lines:
                logger.info("paramStats %s", line)


class CheckpointListener(TrainingListener):
    """Periodic model checkpoints with a keep policy
    (the reference's CheckpointListener/LocalFileModelSaver role):
    save every N iterations and/or every N epochs as ModelSerializer zips,
    keeping the most recent `keep_last`. Writes are atomic
    (resilience/checkpoint.py temp+fsync+rename). Prefer
    `resilience.CheckpointListener` for new code: it adds manifests
    (sha256, generator state), every-N-seconds triggers, keep-every
    rotation, and resume via CheckpointManager."""

    def __init__(self, directory: str, save_every_n_iterations: int = 0,
                 save_every_n_epochs: int = 0, keep_last: int = 3):
        import os

        self.directory = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = max(1, keep_last)
        self._saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag: str):
        import os

        # lazy: resilience.checkpoint imports this module for the
        # TrainingListener base — a top-level import would cycle
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            atomic_write_model,
        )

        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        atomic_write_model(model, path)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def checkpoints(self) -> List[str]:
        return list(self._saved)

    def iteration_done(self, model, iteration: int, score: float):
        if self.every_iter and iteration and iteration % self.every_iter == 0:
            if getattr(model, "_window_replay", False):
                # a step window's replay: the params are the window's end
                # while `iteration` is inside it; save at the window's end
                self._pending_iter = True
                return
            self._save(model, f"iter_{iteration}")

    def on_window_end(self, model):
        if getattr(self, "_pending_iter", False):
            self._pending_iter = False
            self._save(model, f"iter_{model.iteration}")

    def on_epoch_end(self, model, epoch: int):
        if self.every_epoch and (epoch + 1) % self.every_epoch == 0:
            self._save(model, f"epoch_{epoch}")


class ProfilerListener(TrainingListener):
    """torch.profiler trace over a window of training iterations (the JAX
    package's jax.profiler hook behind the listener SPI). Traces
    iterations [start_iteration, start_iteration + num_iterations), the
    host and, on a card, the device, and writes a Chrome trace where
    jax.profiler writes its own: `log_dir/plugins/profile/<run>/`, one
    `<host>.<n>.pt.trace.json` per traced window."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 num_iterations: int = 5):
        self.log_dir = log_dir
        self.start = start_iteration
        self.end = start_iteration + num_iterations
        self._prof = None
        self.traces: List[str] = []

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def iteration_done(self, model, iteration: int, score: float):
        if not self._active and self.start <= iteration < self.end:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.start()
            except Exception as e:  # profiling must never kill training
                logger.warning("profiler start failed: %s", e)
                self._prof = None
                self.end = iteration  # don't retry
        elif self._active and iteration >= self.end:
            self._stop()

    def on_fit_end(self, model):
        """Flush a trace window that straddles the end of training. Under
        callers that run fit() once per epoch (EarlyStoppingTrainer), a
        window spanning epochs is flushed at each boundary and restarted
        on the next iteration: several contiguous traces in log_dir."""
        self._stop()

    def _stop(self):
        if not self._active:
            return
        import os
        import socket

        prof, self._prof = self._prof, None
        try:
            prof.stop()
            run = os.path.join(self.log_dir, "plugins", "profile",
                               time.strftime("%Y_%m_%d_%H_%M_%S"))
            os.makedirs(run, exist_ok=True)
            path = os.path.join(
                run, f"{socket.gethostname()}.{len(self.traces)}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.traces.append(path)
        except Exception as e:
            logger.warning("profiler stop failed: %s", e)

    def close(self):
        """Flush an open trace (also runs on GC)."""
        self._stop()

    def __del__(self):
        self._stop()
