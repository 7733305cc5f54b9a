"""DivergenceSentry: detect training divergence and apply a recovery policy
(counterpart of deeplearning4j_tpu/resilience/sentry.py).

The reference's failure detector is InvalidScoreIterationTermination-
Condition (abort on a NaN/Inf score); the sentry puts detection and
recovery behind one listener usable on every fit path
(MultiLayerNetwork, ComputationGraph, ParallelWrapper).

Detection, at every `iteration_done`:
  * a non-finite score (free: the score is already a host float);
  * non-finite params, every `check_params_every` iterations (one host
    read of a flag per leaf; 0 disables);
  * update-norm spikes: ||params_t - params_{t-1}||_2 above `spike_factor`
    times the median of the last `spike_window` norms (None disables).

Policy on a divergence:
  * warn       log and keep training;
  * skip_batch restore the last in-memory snapshot (taken every
               `snapshot_every` finite iterations), erasing the bad step;
  * rollback   restore the newest good checkpoint through the
               CheckpointManager (params, updater, generator, counters),
               else the in-memory snapshot. `max_rollbacks` bounds both
               restoring policies: one divergence past it raises
               FloatingPointError.

Under step windows (training/engine.py) the snapshot is taken at
`on_window_start`, the window's clean start, on the `snapshot_every`
cadence rounded to windows; a trip rewinds to it, consumes one rollback,
and the window's remaining scores (of discarded steps) are not looked at;
params are checked once per window and spikes measured on its first
step. `on_window_end` re-arms the per-step rules.

The port updates params in place (`p.sub_`), so a snapshot holds COPIES:
each param, state and updater slot cloned, the `Draws` generator's state,
`iteration`, `epoch` and `score_`; a restore copies the params back into
the live tensors under no_grad, so anything holding a param tensor sees
the restored values. The JAX package's trip and rollback counters and its
flight-recorder dump are not ported (ROADMAP A.11).
"""
from __future__ import annotations

import logging
import math
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models._training import clone_tree
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

logger = logging.getLogger("deeplearning4j_tpu_torch")

POLICIES = ("warn", "skip_batch", "rollback")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_all_finite(tree) -> bool:
    """True when every floating leaf (tensor or array) of nested dicts,
    lists and tuples is finite; integer leaves are skipped. One host read
    per device."""
    flags = {}
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() or leaf.is_complex():
                flags.setdefault(leaf.device, []).append(
                    torch.isfinite(leaf.detach()).all())
        else:
            a = np.asarray(leaf)
            if (np.issubdtype(a.dtype, np.inexact)
                    and not np.all(np.isfinite(a))):
                return False
    return all(bool(torch.stack(f).all()) for f in flags.values())


def snapshot_training_state(model) -> Dict[str, Any]:
    """Copies of everything a rollback restores: params, running state,
    updater slots (each tensor cloned on its device), the dropout
    generator's state where `draws` is a `Draws`, `iteration`, `epoch`
    and the last score."""
    gen = getattr(getattr(model, "draws", None), "generator", None)
    return {
        "params": clone_tree(model.params),
        "state": clone_tree(model.state),
        "opt_state": (None if model.opt_state is None
                      else clone_tree(model.opt_state)),
        "iteration": int(model.iteration),
        "epoch": int(model.epoch),
        "rng": None if gen is None else gen.get_state().clone(),
        "score": float(getattr(model, "score_", float("nan"))),
    }


def _copy_into(live, saved):
    """`saved`'s tensors copied into `live`'s of the same structure."""
    if isinstance(live, dict):
        for k, v in live.items():
            _copy_into(v, saved[k])
    elif isinstance(live, (list, tuple)):
        for a, b in zip(live, saved):
            _copy_into(a, b)
    elif isinstance(live, torch.Tensor):
        live.copy_(saved)


def restore_training_state(model, snap: Dict[str, Any],
                           restore_score: bool = True) -> None:
    """The inverse of `snapshot_training_state`: the params copied back
    into the live tensors under no_grad, the state and updater slots
    replaced by copies (the snapshot stays reusable), the counters and the
    generator set back. `restore_score=False` keeps the live `score_`."""
    with torch.no_grad():
        _copy_into(model.params, snap["params"])
    model.state = clone_tree(snap["state"])
    if snap["opt_state"] is not None:
        model.opt_state = clone_tree(snap["opt_state"])
    model.iteration = snap["iteration"]
    model.epoch = snap["epoch"]
    gen = getattr(getattr(model, "draws", None), "generator", None)
    if snap["rng"] is not None and gen is not None:
        gen.set_state(snap["rng"])
    if restore_score and "score" in snap:
        model.score_ = snap["score"]


def _flat_params(params) -> np.ndarray:
    """Every floating param as one float64 host vector (sorted keys)."""
    leaves = [t.detach().to("cpu", torch.float64).reshape(-1)
              for t in _leaves(params)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return (torch.cat(leaves).numpy() if leaves
            else np.zeros(0, np.float64))


class DivergenceSentry(TrainingListener):
    """See the module docstring."""

    def __init__(self, checkpoint_manager=None, policy: str = "warn",
                 max_rollbacks: int = 3, snapshot_every: int = 1,
                 check_params_every: int = 0,
                 spike_factor: Optional[float] = None,
                 spike_window: int = 16, on_empty: str = "raise"):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if on_empty not in ("raise", "reinit"):
            raise ValueError(f"on_empty {on_empty!r} not in (raise, reinit)")
        if policy == "rollback" and checkpoint_manager is None:
            logger.warning("DivergenceSentry(policy='rollback') without a "
                           "CheckpointManager: recovery is in-memory only")
        self.manager = checkpoint_manager
        self.policy = policy
        self.max_rollbacks = int(max_rollbacks)
        self.snapshot_every = max(0, int(snapshot_every))
        self.check_params_every = max(0, int(check_params_every))
        self.spike_factor = spike_factor
        self.on_empty = on_empty
        self._norms: deque = deque(maxlen=max(2, int(spike_window)))
        self.divergences = 0  # detections
        self.rollbacks = 0  # budget consumed by skip_batch / rollback
        self._snapshot: Optional[Dict[str, Any]] = None
        self._prev_flat: Optional[np.ndarray] = None
        # step-window state (on_window_start / on_window_end / on_fit_start)
        self._windowed = False
        self._window_tripped = False
        self._window_fresh = True
        self._burst_params_checked = False
        self._snap_iteration: Optional[int] = None

    # ---- detection ----
    def _params_finite(self, model) -> bool:
        return tree_all_finite(model.params)

    def _update_spiked(self, flat: np.ndarray) -> bool:
        prev, self._prev_flat = self._prev_flat, flat
        if prev is None or prev.shape != flat.shape:
            return False
        norm = float(np.linalg.norm(flat - prev))
        if not math.isfinite(norm):
            return True
        median = (float(np.median(self._norms))
                  if len(self._norms) >= 4 else 0.0)
        spiked = median > 0.0 and norm > self.spike_factor * median
        if not spiked:  # spikes stay out of the rolling median
            self._norms.append(norm)
        return spiked

    # ---- snapshots ----
    def _take_snapshot(self, model) -> None:
        self._snap_iteration = int(model.iteration)
        self._snapshot = snapshot_training_state(model)

    def _restore_snapshot(self, model) -> None:
        snap = self._snapshot
        # the diverged score_ stays until the next step replaces it
        restore_training_state(model, snap, restore_score=False)
        self._prev_flat = _flat_params(snap["params"])

    # ---- recovery ----
    def handle_divergence(self, model, reason: str = "non-finite score"):
        """Apply the policy. Returns the restored checkpoint's manifest
        (rollback through the manager), {} (a snapshot restore or a
        re-init) or None (warn). Raises FloatingPointError once the
        budget is spent, or with nothing to restore."""
        self.divergences += 1
        if self.policy == "warn":
            logger.warning("divergence detected (%s); policy=warn: "
                           "continuing", reason)
            return None
        if self.rollbacks >= self.max_rollbacks:
            raise FloatingPointError(
                f"divergence ({reason}) after {self.rollbacks} "
                f"rollback(s): retry budget max_rollbacks="
                f"{self.max_rollbacks} exhausted")
        self.rollbacks += 1
        if self.policy == "rollback" and self.manager is not None:
            manifest = self.manager.restore_into(model)
            if manifest is not None:
                logger.warning("divergence (%s): rolled back to checkpoint "
                               "step %s (%d/%d)", reason,
                               manifest.get("step"), self.rollbacks,
                               self.max_rollbacks)
                self._prev_flat = _flat_params(model.params)
                return manifest
        if self._snapshot is not None:
            self._restore_snapshot(model)
            logger.warning("divergence (%s): restored the in-memory "
                           "snapshot at iteration %d (%d/%d)", reason,
                           model.iteration, self.rollbacks,
                           self.max_rollbacks)
            return {}
        if self.on_empty == "reinit":
            model.init(model.device)
            logger.warning("divergence (%s): nothing to roll back to, "
                           "re-initialized the params (%d/%d)", reason,
                           self.rollbacks, self.max_rollbacks)
            return {}
        raise FloatingPointError(
            f"divergence ({reason}) with nothing to roll back to "
            f"(no valid checkpoint, no snapshot)")

    # ---- listener SPI ----
    def on_fit_start(self, model):
        """Each fit decides windowed or per-step afresh: a windowed fit
        must not switch off the per-step rules of a later one."""
        self._windowed = False
        self._window_tripped = False
        self._window_fresh = True

    def on_window_start(self, model):
        """A step window is about to run K steps before any score is
        read: snapshot the clean start here (on the `snapshot_every`
        cadence, rounded to windows), and hold the per-step snapshots
        until the window ends. Detection stays per step."""
        self._windowed = True
        self._window_tripped = False
        self._burst_params_checked = False
        if (self.policy != "warn" and self.snapshot_every
                and (self._snapshot is None or self._snap_iteration is None
                     or (int(model.iteration) - self._snap_iteration
                         >= self.snapshot_every))):
            self._take_snapshot(model)
        # the params stay at the window's end through the replay: only
        # its first step measures an update
        self._window_fresh = True

    def on_window_end(self, model):
        """The replay is over: per-step detection, snapshots and recovery
        re-arm until the next window."""
        self._windowed = False
        self._window_tripped = False

    def _should_check_params(self) -> bool:
        """Once per replay: the params do not change across it."""
        if self._windowed and self._burst_params_checked:
            return False
        self._burst_params_checked = True
        return True

    def iteration_done(self, model, iteration: int, score: float):
        if self._windowed and self._window_tripped:
            # a trip already rewound this window: the remaining scores
            # are of discarded steps, and must not spend the budget
            return
        reason = None
        if not math.isfinite(score):
            reason = f"non-finite score {score} at iteration {iteration}"
        elif (self.check_params_every
              and iteration % self.check_params_every == 0
              and self._should_check_params()
              and not self._params_finite(model)):
            reason = f"non-finite parameters at iteration {iteration}"
        elif (self.spike_factor is not None
              and (not self._windowed or self._window_fresh)):
            self._window_fresh = False
            if self._update_spiked(_flat_params(model.params)):
                reason = (f"update-norm spike at iteration {iteration} "
                          f"(> {self.spike_factor}x rolling median)")
        if reason is not None:
            self._window_tripped = True
            self.handle_divergence(model, reason)
            return
        if (self.policy != "warn" and self.snapshot_every
                and iteration % self.snapshot_every == 0
                and not self._windowed):
            self._take_snapshot(model)
