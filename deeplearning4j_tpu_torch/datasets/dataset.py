"""DataSet and MultiDataSet containers (counterpart of
deeplearning4j_tpu/datasets/dataset.py; ND4J's DataSet: features, labels,
featuresMask, labelsMask), the currency of every iterator and fit() call.
A MultiDataSet holds a list of each, one entry per graph input or output
(ComputationGraph's currency).

The arrays may be numpy arrays or torch tensors, on the host or already on
the card: `fit` moves a host array to the network's device and takes a
tensor that is already there as it is, without a copy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclass
class DataSet:
    features: object
    labels: object
    features_mask: Optional[object] = None
    labels_mask: Optional[object] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        return (
            DataSet(self.features[:n_train], self.labels[:n_train],
                    _sl(self.features_mask, None, n_train),
                    _sl(self.labels_mask, None, n_train)),
            DataSet(self.features[n_train:], self.labels[n_train:],
                    _sl(self.features_mask, n_train, None),
                    _sl(self.labels_mask, n_train, None)),
        )

    def shuffle(self, seed: Optional[int] = None):
        """Permute the examples in place of this DataSet's fields, with a
        numpy generator from `seed` (the JAX package's permutation)."""
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        self.features = _take(self.features, idx)
        self.labels = _take(self.labels, idx)
        self.features_mask = _take(self.features_mask, idx)
        self.labels_mask = _take(self.labels_mask, idx)

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [
            DataSet(self.features[i:i + batch_size],
                    self.labels[i:i + batch_size],
                    _sl(self.features_mask, i, i + batch_size),
                    _sl(self.labels_mask, i, i + batch_size))
            for i in range(0, n, batch_size)
        ]

    @staticmethod
    def merge(sets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            _cat([d.features for d in sets]),
            _cat([d.labels for d in sets]),
            _cat([d.features_mask for d in sets]),
            _cat([d.labels_mask for d in sets]),
        )


@dataclass
class MultiDataSet:
    """Multiple input/output arrays (ComputationGraph currency)."""

    features: List[object] = field(default_factory=list)
    labels: List[object] = field(default_factory=list)
    features_masks: Optional[List[Optional[object]]] = None
    labels_masks: Optional[List[Optional[object]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def from_dataset(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet(
            [ds.features], [ds.labels],
            [ds.features_mask] if ds.features_mask is not None else None,
            [ds.labels_mask] if ds.labels_mask is not None else None,
        )


def _sl(a, lo, hi):
    return None if a is None else a[lo:hi]


def _take(a, idx: np.ndarray):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def _cat(arrs):
    if any(a is None for a in arrs):
        return None
    if any(isinstance(a, torch.Tensor) for a in arrs):
        return torch.cat([torch.as_tensor(a) for a in arrs])
    return np.concatenate(arrs)
