"""EvaluationBinary: per-output binary metrics for multi-label sigmoid
networks (eval/EvaluationBinary.java). Each output column is an independent
binary problem at decision threshold 0.5 (or per-column custom).

The port's own copy of deeplearning4j_tpu/eval/binary.py (numpy only, the
same names, fields, `merge` and statistics).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class EvaluationBinary:
    def __init__(self, num_outputs: Optional[int] = None,
                 decision_threshold: Optional[np.ndarray] = None):
        self.num_outputs = num_outputs
        self.threshold = decision_threshold
        self._init_done = False

    def _ensure(self, c):
        if not self._init_done:
            self.num_outputs = self.num_outputs or c
            z = np.zeros(self.num_outputs, np.int64)
            self.tp, self.fp, self.tn, self.fn = z.copy(), z.copy(), z.copy(), z.copy()
            self._init_done = True

    def is_empty(self) -> bool:
        if not self._init_done:
            return True
        return int(self.tp.sum() + self.fp.sum()
                   + self.tn.sum() + self.fn.sum()) == 0

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        th = self.threshold if self.threshold is not None else 0.5
        pred = predictions >= th
        act = labels > 0.5
        self.tp += np.sum(pred & act, axis=0)
        self.fp += np.sum(pred & ~act, axis=0)
        self.tn += np.sum(~pred & ~act, axis=0)
        self.fn += np.sum(~pred & act, axis=0)

    def accuracy(self, c: int) -> float:
        tot = self.tp[c] + self.fp[c] + self.tn[c] + self.fn[c]
        return float((self.tp[c] + self.tn[c]) / max(tot, 1))

    def precision(self, c: int) -> float:
        return float(self.tp[c] / max(self.tp[c] + self.fp[c], 1))

    def recall(self, c: int) -> float:
        return float(self.tp[c] / max(self.tp[c] + self.fn[c], 1))

    def f1(self, c: int) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / max(p + r, 1e-12)

    def average_accuracy(self) -> float:
        return float(np.mean([self.accuracy(i) for i in range(self.num_outputs)]))

    def average_f1(self) -> float:
        return float(np.mean([self.f1(i) for i in range(self.num_outputs)]))

    def merge(self, other: "EvaluationBinary"):
        if not other._init_done:
            return self
        if not self._init_done:
            self._ensure(other.num_outputs)
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        return self

    def stats(self) -> str:
        lines = ["Label   Acc     Precision  Recall   F1"]
        for c in range(self.num_outputs):
            lines.append(f"{c:<8}{self.accuracy(c):<8.4f}{self.precision(c):<11.4f}"
                         f"{self.recall(c):<9.4f}{self.f1(c):<.4f}")
        return "\n".join(lines)
