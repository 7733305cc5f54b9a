"""EvaluationCalibration: reliability diagrams + histograms of predicted
probabilities and residuals (eval/EvaluationCalibration.java,
eval/curves/ReliabilityDiagram.java).

The port's own copy of deeplearning4j_tpu/eval/calibration.py (numpy only, the
same names, fields, `merge` and statistics).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._init_done = False

    def _ensure(self, c):
        if not self._init_done:
            self.num_classes = c
            self.bin_count = np.zeros((c, self.reliability_bins), np.int64)
            self.bin_pos = np.zeros((c, self.reliability_bins), np.int64)
            self.bin_prob_sum = np.zeros((c, self.reliability_bins), np.float64)
            self.prob_hist = np.zeros((c, self.histogram_bins), np.int64)
            self.residual_hist = np.zeros((c, self.histogram_bins), np.int64)
            self._init_done = True

    def is_empty(self) -> bool:
        return not self._init_done or int(self.bin_count.sum()) == 0

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
        self._ensure(labels.shape[-1])
        for c in range(self.num_classes):
            p = np.clip(predictions[:, c], 0.0, 1.0)
            l = labels[:, c] > 0.5
            bins = np.minimum((p * self.reliability_bins).astype(int),
                              self.reliability_bins - 1)
            np.add.at(self.bin_count[c], bins, 1)
            np.add.at(self.bin_pos[c], bins[l], 1)
            np.add.at(self.bin_prob_sum[c], bins, p)
            h = np.minimum((p * self.histogram_bins).astype(int),
                           self.histogram_bins - 1)
            np.add.at(self.prob_hist[c], h, 1)
            res = np.clip(np.abs(labels[:, c] - p), 0.0, 1.0)
            hr = np.minimum((res * self.histogram_bins).astype(int),
                            self.histogram_bins - 1)
            np.add.at(self.residual_hist[c], hr, 1)

    def reliability_diagram(self, c: int) -> Tuple[np.ndarray, np.ndarray]:
        """(mean predicted prob, empirical fraction positive) per bin."""
        cnt = np.maximum(self.bin_count[c], 1)
        return self.bin_prob_sum[c] / cnt, self.bin_pos[c] / cnt

    def get_reliability_diagram(self, c: int):
        """ReliabilityDiagram value object (curves/ReliabilityDiagram.java)."""
        from deeplearning4j_tpu_torch.eval.curves import ReliabilityDiagram

        mean_p, frac = self.reliability_diagram(c)
        return ReliabilityDiagram(title=f"class {c}",
                                  mean_predicted=[float(v) for v in mean_p],
                                  fraction_positive=[float(v) for v in frac])

    def get_probability_histogram(self, c: int):
        from deeplearning4j_tpu_torch.eval.curves import Histogram

        return Histogram(title=f"P(class {c})", lower=0.0, upper=1.0,
                         counts=[int(v) for v in self.prob_hist[c]])

    def get_residual_histogram(self, c: int):
        from deeplearning4j_tpu_torch.eval.curves import Histogram

        return Histogram(title=f"|label-p| class {c}", lower=0.0, upper=1.0,
                         counts=[int(v) for v in self.residual_hist[c]])

    def expected_calibration_error(self, c: int) -> float:
        cnt = self.bin_count[c]
        tot = max(cnt.sum(), 1)
        mean_p, frac = self.reliability_diagram(c)
        return float(np.sum(cnt / tot * np.abs(mean_p - frac)))

    def merge(self, other: "EvaluationCalibration"):
        if not other._init_done:
            return self
        if not self._init_done:
            self._ensure(other.num_classes)
        self.bin_count += other.bin_count
        self.bin_pos += other.bin_pos
        self.bin_prob_sum += other.bin_prob_sum
        self.prob_hist += other.prob_hist
        self.residual_hist += other.residual_hist
        return self
