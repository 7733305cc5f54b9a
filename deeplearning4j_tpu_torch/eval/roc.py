"""ROC / AUC evaluation: exact (threshold-free) and thresholded modes,
binary + multi-class + per-output variants.

Reference: eval/ROC.java (thresholdSteps=0 → exact mode storing all
(prob, label) pairs), ROCMultiClass.java (one-vs-all per class),
ROCBinary.java (per independent binary output), curves in eval/curves/
(RocCurve, PrecisionRecallCurve).

The port's own copy of deeplearning4j_tpu/eval/roc.py (numpy only, the
same names, fields, `merge` and statistics); the thresholded mode counts
all thresholds in one comparison where the JAX copy loops over them, with
the same integers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.eval.curves import trapezoid


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal AUC over a curve sorted by x."""
    order = np.argsort(x)
    return float(trapezoid(y[order], x[order]))


class ROC:
    """Binary ROC. threshold_steps=0 → exact mode (store scores);
    >0 → histogram mode with that many thresholds (bounded memory)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        if threshold_steps > 0:
            self._thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
            self._tp = np.zeros(threshold_steps + 1, np.int64)
            self._fp = np.zeros(threshold_steps + 1, np.int64)
        self._pos = 0
        self._neg = 0

    def is_empty(self) -> bool:
        return self._pos + self._neg == 0

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            # [neg, pos] one-hot columns: positive class = column 1
            labels = labels[..., 1]
            predictions = predictions[..., 1]
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        pos = labels > 0.5
        self._pos += int(pos.sum())
        self._neg += int((~pos).sum())
        if self.threshold_steps > 0:
            # every threshold in one comparison: the JAX loop's integers
            sel = predictions[None, :] >= self._thresholds[:, None]
            self._tp += (sel & pos).sum(axis=1)
            self._fp += (sel & ~pos).sum(axis=1)
        else:
            self._scores.append(predictions)
            self._labels.append(labels)

    def _exact_curve(self) -> Tuple[np.ndarray, np.ndarray]:
        s = np.concatenate(self._scores)
        l = np.concatenate(self._labels) > 0.5
        order = np.argsort(-s)
        l = l[order]
        tps = np.cumsum(l)
        fps = np.cumsum(~l)
        tpr = tps / max(self._pos, 1)
        fpr = fps / max(self._neg, 1)
        return np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr])

    def calculate_auc(self) -> float:
        if self.threshold_steps > 0:
            tpr = self._tp / max(self._pos, 1)
            fpr = self._fp / max(self._neg, 1)
            return _auc(fpr, tpr)
        fpr, tpr = self._exact_curve()
        return _auc(fpr, tpr)

    def _pr_arrays(self):
        if self.threshold_steps > 0:
            prec = self._tp / np.maximum(self._tp + self._fp, 1)
            rec = self._tp / max(self._pos, 1)
            return rec, prec
        s = np.concatenate(self._scores)
        l = np.concatenate(self._labels) > 0.5
        order = np.argsort(-s)
        l = l[order]
        tps = np.cumsum(l)
        prec = tps / (np.arange(len(l)) + 1)
        rec = tps / max(self._pos, 1)
        return rec, prec

    def calculate_auprc(self) -> float:
        rec, prec = self._pr_arrays()
        return _auc(rec, prec)

    def get_roc_curve(self):
        if self.threshold_steps > 0:
            return (self._fp / max(self._neg, 1), self._tp / max(self._pos, 1))
        return self._exact_curve()

    def roc_curve(self):
        """RocCurve value object (eval/curves/RocCurve.java)."""
        from deeplearning4j_tpu_torch.eval.curves import RocCurve

        fpr, tpr = self.get_roc_curve()
        return RocCurve(fpr=[float(v) for v in fpr],
                        tpr=[float(v) for v in tpr])

    def precision_recall_curve(self):
        """PrecisionRecallCurve value object."""
        from deeplearning4j_tpu_torch.eval.curves import PrecisionRecallCurve

        rec, prec = self._pr_arrays()
        return PrecisionRecallCurve(recall=[float(v) for v in rec],
                                    precision=[float(v) for v in prec])

    def merge(self, other: "ROC"):
        self._pos += other._pos
        self._neg += other._neg
        if self.threshold_steps > 0:
            self._tp += other._tp
            self._fp += other._fp
        else:
            self._scores.extend(other._scores)
            self._labels.extend(other._labels)
        return self


class ROCMultiClass:
    """One-vs-all ROC per class (eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._per_class: Dict[int, ROC] = {}

    def is_empty(self) -> bool:
        return all(r.is_empty() for r in self._per_class.values())

    def eval(self, labels, predictions):
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        predictions = np.asarray(predictions).reshape(labels.shape)
        for c in range(labels.shape[-1]):
            roc = self._per_class.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c], predictions[:, c])

    def calculate_auc(self, c: int) -> float:
        return self._per_class[c].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._per_class.values()]))

    def merge(self, other: "ROCMultiClass"):
        for c, r in other._per_class.items():
            if c in self._per_class:
                self._per_class[c].merge(r)
            else:
                self._per_class[c] = r
        return self


class ROCBinary(ROCMultiClass):
    """Per independent binary output (eval/ROCBinary.java) — same per-column
    machinery, but columns are independent sigmoid outputs."""

    pass
