"""Classification evaluation: accuracy/precision/recall/F1 + confusion matrix.

Reference: eval/Evaluation.java, eval/ConfusionMatrix.java. Merge-able across
workers (IEvaluation.merge contract) — the distributed-eval primitive used by
spark/.../evaluation (SURVEY.md §2.1 'Evaluation' row).

Accumulation is a [C, C] numpy confusion matrix on host — evaluation is
streaming over minibatches; the heavy part (model.output) already ran on the device.
RNN output [b, t, c] is flattened over time with mask support.

The port's own copy of deeplearning4j_tpu/eval/evaluation.py (numpy only, the
same names, fields and JSON, so either package reads the other's
`to_json`).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def merge(self, other: "ConfusionMatrix"):
        self.matrix += other.matrix

    def __str__(self):
        return str(self.matrix)


def _flatten_time(labels, preds, mask):
    """[b, t, c] -> [b*t, c] with optional [b, t] mask filtering."""
    if labels.ndim == 3:
        b, t, c = labels.shape
        labels = labels.reshape(b * t, c)
        preds = preds.reshape(b * t, c)
        if mask is not None:
            m = np.asarray(mask).reshape(-1) > 0
            labels, preds = labels[m], preds[m]
    elif mask is not None:
        m = np.asarray(mask).reshape(-1) > 0
        labels, preds = labels[m], preds[m]
    return labels, preds


class Evaluation:
    """Streaming classification metrics; `eval()` per minibatch, metrics on
    demand. top_n mirrors Evaluation(int topN)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self.top_n = top_n
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.total = 0

    def _ensure(self, c):
        if self.confusion is None:
            self.num_classes = self.num_classes or c
            self.confusion = ConfusionMatrix(self.num_classes)

    def is_empty(self) -> bool:
        """True iff no example has been accumulated (IEvaluation protocol —
        distributed.evaluate_shards uses this to reject reused
        prototypes)."""
        return self.confusion is None or self.total == 0

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        labels, predictions = _flatten_time(labels, predictions, mask)
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels, axis=-1)
        pred = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion.matrix, (actual, pred), 1)
        self.total += len(actual)
        if self.top_n > 1:
            topk = np.argsort(-predictions, axis=-1)[:, : self.top_n]
            self.top_n_correct += int(np.sum(topk == actual[:, None]))
        else:
            self.top_n_correct += int(np.sum(actual == pred))

    # ---- metrics ----
    def accuracy(self) -> float:
        m = self.confusion.matrix
        return float(np.trace(m) / max(m.sum(), 1))

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / max(self.total, 1)

    def true_positives(self, c: int) -> int:
        return int(self.confusion.matrix[c, c])

    def false_positives(self, c: int) -> int:
        return int(self.confusion.matrix[:, c].sum() - self.confusion.matrix[c, c])

    def false_negatives(self, c: int) -> int:
        return int(self.confusion.matrix[c, :].sum() - self.confusion.matrix[c, c])

    def precision(self, c: Optional[int] = None) -> float:
        if c is not None:
            tp, fp = self.true_positives(c), self.false_positives(c)
            return tp / max(tp + fp, 1)
        vals = [self.precision(i) for i in range(self.num_classes)
                if self.confusion.matrix[:, i].sum() + self.confusion.matrix[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c: Optional[int] = None) -> float:
        if c is not None:
            tp, fn = self.true_positives(c), self.false_negatives(c)
            return tp / max(tp + fn, 1)
        vals = [self.recall(i) for i in range(self.num_classes)
                if self.confusion.matrix[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c: Optional[int] = None) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / max(p + r, 1e-12)

    def matthews_correlation(self, c: int) -> float:
        tp = self.true_positives(c)
        fp = self.false_positives(c)
        fn = self.false_negatives(c)
        tn = self.total - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0

    def merge(self, other: "Evaluation"):
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(self.num_classes)
        self.confusion.merge(other.confusion)
        self.total += other.total
        self.top_n_correct += other.top_n_correct
        return self

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes: {self.num_classes}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} acc: {self.top_n_accuracy():.4f}")
        lines.append("=================Confusion Matrix=================")
        lines.append(str(self.confusion))
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "num_classes": self.num_classes,
            "matrix": self.confusion.matrix.tolist() if self.confusion is not None else None,
            "total": self.total,
            "top_n": self.top_n,
            "top_n_correct": self.top_n_correct,
        })

    @classmethod
    def from_json(cls, s: str) -> "Evaluation":
        d = json.loads(s)
        ev = cls(num_classes=d["num_classes"], top_n=d.get("top_n", 1))
        if d.get("matrix") is not None:
            ev.confusion = ConfusionMatrix(d["num_classes"])
            ev.confusion.matrix = np.asarray(d["matrix"], np.int64)
        ev.total = d["total"]
        ev.top_n_correct = d.get("top_n_correct", 0)
        return ev
