"""Early stopping: configuration, trainer, model savers and termination
conditions (counterpart of deeplearning4j_tpu/earlystopping/core.py).

Reference: earlystopping/ — EarlyStoppingConfiguration, trainer/
BaseEarlyStoppingTrainer + EarlyStoppingTrainer (+Graph variant),
saver/{InMemoryModelSaver,LocalFileModelSaver}, termination/ (6 conditions:
MaxEpochs, BestScoreEpoch, ScoreImprovementEpoch, MaxTime, MaxScore,
InvalidScore), scorecalc/DataSetLossCalculator.

The trainer calls the network's `fit` once per epoch, as the JAX package's
does, so the listeners see one on_fit_start ... on_fit_end per epoch. The
savers write the framework's checkpoint zip (models/serialization.py);
`get_best` restores onto the device of the model last saved through the
saver, or onto `device=` (a saver that saved nothing resolves None to the
card, as every entry point does).
"""
from __future__ import annotations

import io
import os
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# score calculators
# ---------------------------------------------------------------------------


class ScoreCalculator:
    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator
    (earlystopping/scorecalc/DataSetLossCalculator.java). Works for both
    MultiLayerNetwork and ComputationGraph."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            s = model.score(ds)
            b = ds.num_examples()
            total += s * b
            n += b
        return total / max(n, 1) if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """score = -accuracy (lower is better, so maximizing accuracy)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        return -model.evaluate(self.iterator).accuracy()


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------


class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError

    def initialize(self):
        pass


class IterationTerminationCondition:
    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError

    def initialize(self):
        pass


@dataclass
class MaxEpochsTerminationCondition(EpochTerminationCondition):
    max_epochs: int = 10

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs - 1


@dataclass
class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score <= target (earlystopping/termination/
    BestScoreEpochTerminationCondition.java)."""

    best_expected_score: float = 0.0

    def terminate(self, epoch, score):
        return score <= self.best_expected_score


@dataclass
class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without (min_improvement) improvement."""

    max_epochs_without_improvement: int = 5
    min_improvement: float = 0.0

    def initialize(self):
        self._best = float("inf")
        self._stale = 0

    def terminate(self, epoch, score):
        if score < self._best - self.min_improvement:
            self._best = score
            self._stale = 0
        else:
            self._stale += 1
        return self._stale > self.max_epochs_without_improvement


@dataclass
class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    max_seconds: float = 3600.0

    def initialize(self):
        # monotonic: an NTP step must not end (or extend) training
        self._start = time.monotonic()

    def terminate(self, last_score):
        return (time.monotonic() - self._start) > self.max_seconds


@dataclass
class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort when the minibatch score exceeds a bound (diverged)."""

    max_score: float = 1e9

    def terminate(self, last_score):
        return last_score > self.max_score


@dataclass
class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort on NaN/Inf score (earlystopping/termination/
    InvalidScoreIterationTerminationCondition.java — the reference's failure
    detection primitive, SURVEY.md §5)."""

    def terminate(self, last_score):
        return not np.isfinite(last_score)


# ---------------------------------------------------------------------------
# model savers
# ---------------------------------------------------------------------------


class ModelSaver:
    def save_best(self, model):
        raise NotImplementedError

    def save_latest(self, model):
        pass

    def get_best(self):
        raise NotImplementedError


class InMemoryModelSaver(ModelSaver):
    """The best model as checkpoint-zip bytes in memory."""

    def __init__(self):
        self._best = None
        self._device = None

    def save_best(self, model):
        from deeplearning4j_tpu_torch.models.serialization import write_model

        buf = io.BytesIO()
        write_model(model, buf)
        self._best = buf.getvalue()
        self._device = model.device

    def get_best(self, device=None):
        from deeplearning4j_tpu_torch.models.serialization import (
            restore_model,
        )

        if self._best is None:
            return None
        return restore_model(io.BytesIO(self._best),
                             device=device if device is not None
                             else self._device)


class LocalFileModelSaver(ModelSaver):
    """bestModel.zip / latestModel.zip in a directory
    (earlystopping/saver/LocalFileModelSaver.java). Saves go through the
    atomic writer (temp + fsync + rename, resilience/checkpoint.py): a
    crash mid-save can never tear the best model found so far."""

    def __init__(self, directory: str):
        self.directory = directory
        self._device = None
        os.makedirs(directory, exist_ok=True)

    @property
    def best_path(self):
        return os.path.join(self.directory, "bestModel.zip")

    def save_best(self, model):
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            atomic_write_model,
        )

        atomic_write_model(model, self.best_path)
        self._device = model.device

    def save_latest(self, model):
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            atomic_write_model,
        )

        atomic_write_model(model,
                           os.path.join(self.directory, "latestModel.zip"))

    def get_best(self, device=None):
        """The best model restored onto `device`, else onto the device of
        the model this saver last saved, else onto the card."""
        from deeplearning4j_tpu_torch import device as device_mod
        from deeplearning4j_tpu_torch.models.serialization import (
            restore_model,
        )

        device = device_mod.resolve(device if device is not None
                                    else self._device)
        if not os.path.exists(self.best_path):
            return None
        return restore_model(self.best_path, device=device)


# ---------------------------------------------------------------------------
# configuration + trainer
# ---------------------------------------------------------------------------


@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Optional[ScoreCalculator] = None
    model_saver: ModelSaver = field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(
        default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: str = ""
    termination_details: str = ""
    best_model_epoch: int = -1
    best_model_score: float = float("inf")
    total_epochs: int = 0
    score_vs_epoch: dict = field(default_factory=dict)

    def get_best_model(self):
        return self._best_model

    _best_model: Any = None


class EarlyStoppingTrainer:
    """Drives fit() epoch-by-epoch with score evaluation + termination
    (earlystopping/trainer/BaseEarlyStoppingTrainer.java). Same class serves
    MLN and ComputationGraph (the reference splits them only for JVM typing).
    """

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iterator):
        self.config = config
        self.model = model
        self.iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        result = EarlyStoppingResult()
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        epoch = 0
        stop_reason = None
        details = ""
        while True:
            # one epoch with per-iteration abort hooks
            aborted = False
            from deeplearning4j_tpu_torch.optimize.listeners import (
                TrainingListener,
            )

            class _IterGuard(TrainingListener):
                def __init__(self, outer):
                    self.outer = outer
                    self.abort = None

                def iteration_done(self, model, iteration, score):
                    for c in cfg.iteration_termination_conditions:
                        if c.terminate(score):
                            self.abort = type(c).__name__

            guard = _IterGuard(self)
            saved_listeners = list(self.model.listeners)
            self.model.listeners = saved_listeners + [guard]
            try:
                self.model.fit(self.iterator, epochs=1)
            finally:
                self.model.listeners = saved_listeners
            if guard.abort:
                stop_reason = "IterationTerminationCondition"
                details = guard.abort
                break

            # epoch-end score
            if cfg.score_calculator is not None and \
                    epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
            else:
                score = self.model.score_
            result.score_vs_epoch[epoch] = score
            if score < result.best_model_score:
                result.best_model_score = score
                result.best_model_epoch = epoch
                cfg.model_saver.save_best(self.model)
            if cfg.save_last_model:
                cfg.model_saver.save_latest(self.model)

            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score):
                    stop_reason = "EpochTerminationCondition"
                    details = type(c).__name__
                    break
            if stop_reason:
                break
            epoch += 1

        result.termination_reason = stop_reason or "unknown"
        result.termination_details = details
        result.total_epochs = epoch + 1
        result._best_model = cfg.model_saver.get_best()
        return result


# Graph alias for API parity
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
