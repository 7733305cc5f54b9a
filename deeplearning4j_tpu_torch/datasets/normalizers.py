"""Data normalizers (counterpart of deeplearning4j_tpu/datasets/normalizers.py):
ND4J's NormalizerStandardize, NormalizerMinMaxScaler and
ImagePreProcessingScaler, the DataNormalization surface a checkpoint zip
carries (`normalizer.json` in the framework's own zips, `normalizer.bin` in
DL4J's, util/ModelSerializer.java:39-127).

`fit(data)` accumulates statistics over a DataSet or an iterable of them;
`transform(ds)` returns a new, normalized DataSet and `revert(ds)` undoes
it. Statistics are float32 tensors on the device of the data they were
fitted on (the CPU after `from_json` or `normalizer.bin`), moved once to the
device of the data they transform. Features come back as float32 tensors on
their own device, so a normalizer rides the input pipeline of a network on
the card (`DataSetIterator.set_pre_processor`). The arithmetic is the JAX
package's: sums in float64 for the standardizer, 1e-12 floors on the
variance and on the min-max range.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


def _t(a) -> torch.Tensor:
    """An array or tensor as a tensor (on its own device)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a))


def _f32(a, device=None) -> Optional[torch.Tensor]:
    """A float32 tensor of `a` on `device` (None: its own); None stays."""
    if a is None:
        return None
    t = _t(a).to(torch.float32)
    return t if device is None else t.to(device)


def _rows(a) -> torch.Tensor:
    """[..., f] as [rows, f]."""
    a = _t(a)
    return a.reshape(-1, a.shape[-1])


def _list(t: Optional[torch.Tensor]):
    return None if t is None else t.detach().cpu().tolist()


class Normalizer:
    def fit(self, data):
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(d: dict) -> "Normalizer":
        cls = {c.__name__: c for c in
               [NormalizerStandardize, NormalizerMinMaxScaler,
                ImagePreProcessingScaler]}[d["type"]]
        return cls._from_json(d)

    def _on(self, device, *names) -> None:
        """Move the named statistics to `device` (once: a tensor already
        there stays as it is)."""
        for name in names:
            v = getattr(self, name)
            if v is not None and v.device != device:
                setattr(self, name, v.to(device))


class NormalizerStandardize(Normalizer):
    """Zero mean, unit variance per feature over every axis but the last,
    optionally for the labels too (fitLabel)."""

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = fit_labels
        self.mean = self.std = None
        self.label_mean = self.label_std = None

    def fit(self, data):
        n, s, s2 = 0, None, None
        ln, ls, ls2 = 0, None, None
        for ds in _iter(data):
            x = _rows(ds.features).to(torch.float64)
            s = x.sum(0) if s is None else s + x.sum(0)
            s2 = (x * x).sum(0) if s2 is None else s2 + (x * x).sum(0)
            n += x.shape[0]
            if self.fit_labels:
                y = _rows(ds.labels).to(torch.float64)
                ls = y.sum(0) if ls is None else ls + y.sum(0)
                ls2 = (y * y).sum(0) if ls2 is None else ls2 + (y * y).sum(0)
                ln += y.shape[0]
        self.mean, self.std = _moments(s, s2, n)
        if self.fit_labels:
            self.label_mean, self.label_std = _moments(ls, ls2, ln)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        x = _f32(ds.features)
        self._on(x.device, "mean", "std", "label_mean", "label_std")
        y = ds.labels
        if self.fit_labels and self.label_mean is not None:
            y = (_f32(y) - self.label_mean) / self.label_std
        return DataSet((x - self.mean) / self.std, y, ds.features_mask,
                       ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        x = _f32(ds.features)
        self._on(x.device, "mean", "std", "label_mean", "label_std")
        y = ds.labels
        if self.fit_labels and self.label_mean is not None:
            y = self.revert_labels(y)
        return DataSet(x * self.std + self.mean, y, ds.features_mask,
                       ds.labels_mask)

    def revert_labels(self, y):
        if self.fit_labels and self.label_mean is not None:
            y = _f32(y)
            self._on(y.device, "label_mean", "label_std")
            return y * self.label_std + self.label_mean
        return y

    def to_json(self):
        return {"type": "NormalizerStandardize",
                "mean": _list(self.mean), "std": _list(self.std),
                "fit_labels": self.fit_labels,
                "label_mean": _list(self.label_mean),
                "label_std": _list(self.label_std)}

    @classmethod
    def _from_json(cls, d):
        n = cls(d.get("fit_labels", False))
        n.mean, n.std = _f32(d["mean"]), _f32(d["std"])
        if d.get("label_mean") is not None:
            n.label_mean = _f32(d["label_mean"])
            n.label_std = _f32(d["label_std"])
        return n


def _moments(s, s2, n):
    """(mean, std) as float32 from float64 sums, the variance floored at
    1e-12."""
    mean = s / n
    var = s2 / n - mean ** 2
    return (mean.to(torch.float32),
            torch.sqrt(var.clamp_min(1e-12)).to(torch.float32))


class NormalizerMinMaxScaler(Normalizer):
    """Each feature's [min, max] onto [min_range, max_range]."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 fit_labels: bool = False):
        self.min_range = min_range
        self.max_range = max_range
        self.fit_labels = fit_labels
        self.data_min = self.data_max = None
        self.label_min = self.label_max = None

    def fit(self, data):
        lo = hi = llo = lhi = None
        for ds in _iter(data):
            x = _rows(ds.features)
            mn, mx = x.min(0).values, x.max(0).values
            lo = mn if lo is None else torch.minimum(lo, mn)
            hi = mx if hi is None else torch.maximum(hi, mx)
            if self.fit_labels:
                y = _rows(ds.labels)
                lmn, lmx = y.min(0).values, y.max(0).values
                llo = lmn if llo is None else torch.minimum(llo, lmn)
                lhi = lmx if lhi is None else torch.maximum(lhi, lmx)
        self.data_min, self.data_max = _f32(lo), _f32(hi)
        if self.fit_labels:
            self.label_min, self.label_max = _f32(llo), _f32(lhi)
        return self

    def _scale(self, a, lo, hi):
        a01 = (_f32(a) - lo) / (hi - lo).clamp_min(1e-12)
        return a01 * (self.max_range - self.min_range) + self.min_range

    def _unscale(self, a, lo, hi):
        a01 = (_f32(a) - self.min_range) / (self.max_range - self.min_range)
        return a01 * (hi - lo) + lo

    def _stats_on(self, device):
        self._on(device, "data_min", "data_max", "label_min", "label_max")

    def transform(self, ds: DataSet) -> DataSet:
        x = _f32(ds.features)
        self._stats_on(x.device)
        y = ds.labels
        if self.fit_labels and self.label_min is not None:
            y = self._scale(y, self.label_min, self.label_max)
        return DataSet(self._scale(x, self.data_min, self.data_max), y,
                       ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        x = _f32(ds.features)
        self._stats_on(x.device)
        y = ds.labels
        if self.fit_labels and self.label_min is not None:
            y = self.revert_labels(y)
        return DataSet(self._unscale(x, self.data_min, self.data_max), y,
                       ds.features_mask, ds.labels_mask)

    def revert_labels(self, y):
        if self.fit_labels and self.label_min is not None:
            y = _f32(y)
            self._stats_on(y.device)
            return self._unscale(y, self.label_min, self.label_max)
        return y

    def to_json(self):
        return {"type": "NormalizerMinMaxScaler",
                "min_range": self.min_range, "max_range": self.max_range,
                "fit_labels": self.fit_labels,
                "data_min": _list(self.data_min),
                "data_max": _list(self.data_max),
                "label_min": _list(self.label_min),
                "label_max": _list(self.label_max)}

    @classmethod
    def _from_json(cls, d):
        n = cls(d["min_range"], d["max_range"], d.get("fit_labels", False))
        n.data_min, n.data_max = _f32(d["data_min"]), _f32(d["data_max"])
        if d.get("label_min") is not None:
            n.label_min = _f32(d["label_min"])
            n.label_max = _f32(d["label_max"])
        return n


class ImagePreProcessingScaler(Normalizer):
    """Raw pixels [0, max_pixel] onto [min_range, max_range] (ND4J
    ImagePreProcessingScaler; nothing to fit)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, data):
        return self

    def transform(self, ds: DataSet) -> DataSet:
        x = _f32(ds.features) / self.max_pixel
        x = x * (self.max_range - self.min_range) + self.min_range
        return DataSet(x, ds.labels, ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        x = (_f32(ds.features) - self.min_range) / (self.max_range
                                                     - self.min_range)
        return DataSet(x * self.max_pixel, ds.labels, ds.features_mask,
                       ds.labels_mask)

    def to_json(self):
        return {"type": "ImagePreProcessingScaler",
                "min_range": self.min_range, "max_range": self.max_range,
                "max_pixel": self.max_pixel}

    @classmethod
    def _from_json(cls, d):
        return cls(d["min_range"], d["max_range"], d["max_pixel"])


def _iter(data):
    if isinstance(data, DataSet):
        return [data]
    return data
