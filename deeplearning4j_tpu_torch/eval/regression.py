"""Regression metrics: MSE, MAE, RMSE, RSE, PC (Pearson), R^2 per column.

Reference: eval/RegressionEvaluation.java (streaming accumulators, columns
evaluated independently, merge-able).

The port's own copy of deeplearning4j_tpu/eval/regression.py (numpy only, the
same names, fields, `merge` and statistics).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None):
        self.n = 0
        self.num_columns = num_columns
        self._init_done = False

    def _ensure(self, c):
        if not self._init_done:
            self.num_columns = self.num_columns or c
            z = np.zeros(c, np.float64)
            self.sum_err2 = z.copy()
            self.sum_abs_err = z.copy()
            self.sum_l = z.copy()
            self.sum_p = z.copy()
            self.sum_l2 = z.copy()
            self.sum_p2 = z.copy()
            self.sum_lp = z.copy()
            self._init_done = True

    def is_empty(self) -> bool:
        return self.n == 0

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        err = predictions - labels
        self.n += labels.shape[0]
        self.sum_err2 += np.sum(err * err, axis=0)
        self.sum_abs_err += np.sum(np.abs(err), axis=0)
        self.sum_l += np.sum(labels, axis=0)
        self.sum_p += np.sum(predictions, axis=0)
        self.sum_l2 += np.sum(labels * labels, axis=0)
        self.sum_p2 += np.sum(predictions * predictions, axis=0)
        self.sum_lp += np.sum(labels * predictions, axis=0)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / max(self.n, 1))

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs_err[col] / max(self.n, 1))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int = 0) -> float:
        mean_l = self.sum_l[col] / max(self.n, 1)
        ss_tot = self.sum_l2[col] - self.n * mean_l * mean_l
        return float(self.sum_err2[col] / max(ss_tot, 1e-12))

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.n
        num = n * self.sum_lp[col] - self.sum_l[col] * self.sum_p[col]
        den = np.sqrt(
            (n * self.sum_l2[col] - self.sum_l[col] ** 2)
            * (n * self.sum_p2[col] - self.sum_p[col] ** 2)
        )
        return float(num / max(den, 1e-12))

    def r_squared(self, col: int = 0) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err2 / max(self.n, 1)))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self.sum_abs_err / max(self.n, 1)))

    def merge(self, other: "RegressionEvaluation"):
        if not other._init_done:
            return self
        if not self._init_done:
            self._ensure(other.num_columns)
        self.n += other.n
        for f in ("sum_err2", "sum_abs_err", "sum_l", "sum_p", "sum_l2",
                  "sum_p2", "sum_lp"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def stats(self) -> str:
        cols = range(self.num_columns)
        lines = ["Column    MSE          MAE          RMSE         RSE          PC           R^2"]
        for c in cols:
            lines.append(
                f"col_{c:<5}{self.mean_squared_error(c):<13.5g}"
                f"{self.mean_absolute_error(c):<13.5g}"
                f"{self.root_mean_squared_error(c):<13.5g}"
                f"{self.relative_squared_error(c):<13.5g}"
                f"{self.pearson_correlation(c):<13.5g}"
                f"{self.r_squared(c):<13.5g}"
            )
        return "\n".join(lines)
