"""Dataset fetchers, the part LeNet's path uses: the idx reader and
MnistDataSetIterator (counterpart of deeplearning4j_tpu/datasets/fetchers.py,
a copy of its logic with numpy in place of its native helpers; EMNIST, Iris
and the other fetchers come with later slices).

Nothing is downloaded: the standard idx files are read from a local cache
directory (~/.deeplearning4j_tpu/datasets or $DL4J_TPU_DATA_DIR, the JAX
package's), and when they are absent a deterministic synthetic sample with
the same shapes is made from the seed (flagged `synthetic=True`), the JAX
package's sample bit for bit.
"""
from __future__ import annotations

import gzip
import os
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.util import envflags


def data_dir() -> str:
    return envflags.value(
        "DL4J_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu",
                     "datasets"))


def read_idx(path: str) -> np.ndarray:
    """Read a uint8 idx(1|3) file (optionally .gz) into a uint8 ndarray of
    the header's shape."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    if len(data) < 4 or data[:2] != b"\x00\x00" or data[2] != 0x08:
        raise ValueError(f"{path}: not a uint8 idx file")
    ndim = data[3]
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    total = int(np.prod(dims))
    if len(data) < 4 + 4 * ndim + total:
        raise ValueError(f"{path}: {len(data)} bytes, the header asks for "
                         f"{4 + 4 * ndim + total}")
    return np.frombuffer(data, np.uint8, count=total,
                         offset=4 + 4 * ndim).reshape(dims)


def _find(*names: str) -> Optional[str]:
    for name in names:
        for ext in ("", ".gz"):
            p = os.path.join(data_dir(), name + ext)
            if os.path.exists(p):
                return p
    return None


def _synthetic_images(n: int, h: int, w: int, classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured images: class k = blob at position k."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, classes, n)
    imgs = rng.integers(0, 40, (n, h, w)).astype(np.uint8)
    for i, k in enumerate(ids):
        r = (k * h // classes + h // (2 * classes)) % h
        imgs[i, max(0, r - 2):r + 3, :] = 220
    return imgs, ids


def u8_to_unit(imgs: np.ndarray) -> np.ndarray:
    """uint8 pixels -> float32 in [0, 1] as float32(1 / 255) * x, the JAX
    package's native conversion's rounding."""
    return imgs.astype(np.float32) * np.float32(1.0 / 255.0)


class MnistDataSetIterator(DataSetIterator):
    """MNIST batches, NHWC [b, 28, 28, 1] in [0,1] + one-hot labels
    (datasets/iterator/impl/MnistDataSetIterator.java). Reads the standard
    `train-images-idx3-ubyte(.gz)` files from data_dir(); synthesizes
    structured data when absent."""

    H = W = 28
    CLASSES = 10
    FILES_TRAIN = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    FILES_TEST = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, batch: int = 32, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 123,
                 shuffle: bool = True):
        img_name, lbl_name = self.FILES_TRAIN if train else self.FILES_TEST
        img_path, lbl_path = _find(img_name), _find(lbl_name)
        self.synthetic = img_path is None or lbl_path is None
        if self.synthetic:
            n = num_examples or (1024 if train else 256)
            imgs, ids = _synthetic_images(n, self.H, self.W, self.CLASSES,
                                          seed + (0 if train else 1))
        else:
            imgs = read_idx(img_path)
            ids = read_idx(lbl_path)
            if num_examples:
                imgs, ids = imgs[:num_examples], ids[:num_examples]
        x = u8_to_unit(imgs).reshape(-1, self.H, self.W, 1)
        y = np.zeros((len(ids), self.CLASSES), np.float32)
        y[np.arange(len(ids)), ids.astype(int)] = 1.0
        self._inner = ListDataSetIterator(
            DataSet(x, y), batch=batch, shuffle_each_epoch=shuffle, seed=seed)
        self.batch = batch

    def reset(self):
        self._inner.reset()

    def __next__(self) -> DataSet:
        return next(self._inner)

    def batch_size(self):
        return self.batch

    def total_outcomes(self):
        return self.CLASSES

    def input_columns(self):
        return self.H * self.W
