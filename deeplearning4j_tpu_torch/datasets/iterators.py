"""DataSet iterators (counterpart of the synchronous part of
deeplearning4j_tpu/datasets/iterators.py: DataSetIterator,
ListDataSetIterator). AsyncDataSetIterator, the background-thread prefetch
that the JAX package's fit wraps around every iterator, is not ported yet:
the port's fit iterates in the caller's thread.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterator protocol: iterable over DataSet, with reset()/batch_size().

    `set_pre_processor(p)` attaches a DataSetPreProcessor: every yielded
    batch passes through `p.transform(ds)` (or a bare callable), applied by
    wrapping each subclass's __next__ when the class is created."""

    pre_processor = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        raw = cls.__dict__.get("__next__")
        if raw is not None and not getattr(raw, "_applies_pre_processor",
                                           False):
            def wrapped(self, _raw=raw):
                ds = _raw(self)
                pp = self.pre_processor
                if pp is None:
                    return ds
                return (pp.transform(ds) if hasattr(pp, "transform")
                        else pp(ds))

            wrapped._applies_pre_processor = True
            cls.__next__ = wrapped

    def set_pre_processor(self, p) -> "DataSetIterator":
        self.pre_processor = p
        return self

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        return -1

    def input_columns(self) -> int:
        return -1


class ListDataSetIterator(DataSetIterator):
    """Minibatches of an in-memory DataSet
    (datasets/iterator/impl/ListDataSetIterator.java)."""

    def __init__(self, data: DataSet, batch: int = 32,
                 shuffle_each_epoch: bool = False, seed: int = 0):
        self.data = data
        self.batch = batch
        self.shuffle_each_epoch = shuffle_each_epoch
        self._seed = seed
        self._epoch = 0
        self._pos = 0

    def reset(self):
        self._pos = 0
        if self.shuffle_each_epoch:
            self.data.shuffle(self._seed + self._epoch)
            self._epoch += 1

    def __next__(self):
        if self._pos >= self.data.num_examples():
            raise StopIteration
        lo, hi = self._pos, self._pos + self.batch
        self._pos = hi
        d = self.data
        return DataSet(
            d.features[lo:hi], d.labels[lo:hi],
            None if d.features_mask is None else d.features_mask[lo:hi],
            None if d.labels_mask is None else d.labels_mask[lo:hi],
        )

    def batch_size(self):
        return self.batch

    def total_outcomes(self):
        return int(self.data.labels.shape[-1])

    def input_columns(self):
        return int(np.prod(self.data.features.shape[1:]))
