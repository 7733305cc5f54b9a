"""First-class curve objects — serializable evaluation artifacts.

Reference: eval/curves/{RocCurve,PrecisionRecallCurve,Histogram,
ReliabilityDiagram}.java (SURVEY.md §2.1 Evaluation row): curve data as
JSON-serializable value objects so UIs, reports, and tests consume the same
representation the metrics were computed from.

The port's own copy of deeplearning4j_tpu/eval/curves.py (numpy only, the
same names, fields and JSON, so either package reads the other's
`to_json`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

# numpy 2 renamed trapz; either numpy runs the port
trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _lst(a) -> List[float]:
    return [float(v) for v in np.asarray(a).reshape(-1)]


@dataclass
class BaseCurve:
    def to_json(self) -> dict:
        import dataclasses

        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    @staticmethod
    def from_json(d: dict) -> "BaseCurve":
        d = dict(d)
        t = d.pop("type")
        return _CURVES[t](**d)


@dataclass
class RocCurve(BaseCurve):
    """(fpr, tpr) pairs sorted by threshold (RocCurve.java)."""

    fpr: List[float] = field(default_factory=list)
    tpr: List[float] = field(default_factory=list)

    def area(self) -> float:
        # thresholded-mode curves arrive in descending-x order; integrate
        # over sorted x or the area comes out negated
        order = np.argsort(self.fpr, kind="stable")
        x, y = np.asarray(self.fpr)[order], np.asarray(self.tpr)[order]
        return float(trapezoid(y, x))


@dataclass
class PrecisionRecallCurve(BaseCurve):
    """(recall, precision) pairs (PrecisionRecallCurve.java)."""

    recall: List[float] = field(default_factory=list)
    precision: List[float] = field(default_factory=list)

    def area(self) -> float:
        order = np.argsort(self.recall, kind="stable")
        x = np.asarray(self.recall)[order]
        y = np.asarray(self.precision)[order]
        return float(trapezoid(y, x))


@dataclass
class Histogram(BaseCurve):
    """Fixed-width histogram over [lower, upper] (Histogram.java)."""

    title: str = ""
    lower: float = 0.0
    upper: float = 1.0
    counts: List[int] = field(default_factory=list)

    def bin_edges(self) -> np.ndarray:
        return np.linspace(self.lower, self.upper, len(self.counts) + 1)


@dataclass
class ReliabilityDiagram(BaseCurve):
    """Mean predicted probability vs empirical positive fraction per bin
    (ReliabilityDiagram.java)."""

    title: str = ""
    mean_predicted: List[float] = field(default_factory=list)
    fraction_positive: List[float] = field(default_factory=list)


_CURVES = {c.__name__: c for c in
           (RocCurve, PrecisionRecallCurve, Histogram, ReliabilityDiagram)}
