"""The outer fit lifecycle (counterpart of the `TrainingRun` half of
deeplearning4j_tpu/training/engine.py). MultiLayerNetwork.fit,
ComputationGraph.fit and ParallelWrapper.fit are thin facades: each hands
its per-epoch loop (one `_fit_batch` / `_fit_mds` per batch) to a
`TrainingRun`, which owns

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

The JAX engine's step windows (`DL4J_TPU_STEP_WINDOW` > 1) and device
prefetch are not ported yet: a window above 1 raises NotImplementedError
(ROADMAP A.7); unset or 1 is the per-step loop. Its telemetry, health,
introspection, tuner and flight-recorder calls, and the fit-phase name
(`phase`) that labels them, are not ported either (ROADMAP A.11).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import fire_lifecycle
from deeplearning4j_tpu_torch.util import envflags

_WINDOW_GATE = "DL4J_TPU_STEP_WINDOW"

_ATTACHMENTS = ("checkpoint_manager",)


def window_size(default: int = 1) -> int:
    """Steps rolled into one dispatch (`DL4J_TPU_STEP_WINDOW`): 1 (the
    default, unset or unparsable) is the per-step loop."""
    return max(1, envflags.int_value(_WINDOW_GATE, default))


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
        if window_size() > 1:
            raise NotImplementedError(
                f"{_WINDOW_GATE}={window_size()}: step windows are not "
                f"ported yet (ROADMAP A.7); unset it or set 1 for the "
                f"per-step loop")
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
        """Run the fit: `run_epoch(batches)` trains one pass, where
        `batches` is the epoch's iterable or a zero-argument callable that
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
