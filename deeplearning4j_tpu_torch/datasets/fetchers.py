"""Dataset fetchers: the idx reader and the built-in iterators, MNIST,
EMNIST, Iris, CIFAR-10, SVHN, LFW, TinyImageNet and UCI synthetic control
(counterpart of deeplearning4j_tpu/datasets/fetchers.py, a copy of its
logic with numpy in place of its native helpers; datasets/iterator/impl).

Nothing is downloaded: the standard files (idx, CIFAR binary batches, SVHN
.mat, image trees, iris CSV, UCI text) are read from a local cache
directory (~/.deeplearning4j_tpu/datasets or $DL4J_TPU_DATA_DIR, the JAX
package's), and when they are absent a deterministic synthetic sample with
the same shapes is made from the seed (flagged `synthetic=True`), the JAX
package's sample bit for bit. The image trees (LFW, TinyImageNet) need PIL
to decode: it is imported only when image files are found, and its absence
then raises ImportError; files that are present never give way to the
synthetic sample.
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


class EmnistDataSetIterator(MnistDataSetIterator):
    """EMNIST (letters split by default: 26 classes), same idx format
    (EmnistDataSetIterator.java)."""

    CLASSES = 26
    FILES_TRAIN = ("emnist-letters-train-images-idx3-ubyte",
                   "emnist-letters-train-labels-idx1-ubyte")
    FILES_TEST = ("emnist-letters-test-images-idx3-ubyte",
                  "emnist-letters-test-labels-idx1-ubyte")


class _BuiltInIterator(DataSetIterator):
    """Shared delegation shell for array-backed built-in dataset
    iterators."""

    CLASSES = 0
    _input_cols = 0

    def _wrap(self, x: np.ndarray, ids: np.ndarray, batch: int, seed: int,
              shuffle: bool):
        y = np.zeros((len(ids), self.CLASSES), np.float32)
        y[np.arange(len(ids)), ids.astype(int)] = 1.0
        self._inner = ListDataSetIterator(
            DataSet(x.astype(np.float32), y), batch=batch,
            shuffle_each_epoch=shuffle, seed=seed)
        self.batch = batch
        self._input_cols = int(np.prod(x.shape[1:]))

    def reset(self):
        self._inner.reset()

    def __next__(self) -> DataSet:
        return next(self._inner)

    def batch_size(self):
        return self.batch

    def total_outcomes(self):
        return self.CLASSES

    def input_columns(self):
        return self._input_cols


class IrisDataSetIterator(_BuiltInIterator):
    """The 150x4 iris set (IrisDataSetIterator.java). Reads iris.csv (four
    feature columns and an integer class column) from data_dir() through
    `records.CSVRecordReader`, rows with an unparsable field dropped;
    otherwise the canonical synthetic 3-gaussian sample. Never shuffled."""

    CLASSES = 3

    def __init__(self, batch: int = 150, seed: int = 123):
        path = _find("iris.csv", "iris.data")
        if path:
            from deeplearning4j_tpu_torch.datasets.records import (
                CSVRecordReader,
            )

            m = CSVRecordReader(path).load()
            m = m[~np.isnan(m).any(axis=1)]
            x, ids = m[:, :4], m[:, 4].astype(int)
        else:
            rng = np.random.default_rng(seed)
            centers = rng.normal(0, 2.5, (3, 4))
            ids = rng.integers(0, 3, 150)
            x = (centers[ids] + rng.normal(0, 0.4, (150, 4))).astype(
                np.float32)
        self._wrap(x, ids, batch, seed, shuffle=False)


def _read_raw(path: str) -> bytes:
    """Raw file bytes, gunzipped for a .gz path (as read_idx reads)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _synthetic_rgb(n: int, h: int, w: int, classes: int, seed: int):
    imgs, ids = _synthetic_images(n, h, w, classes, seed)
    return np.repeat(imgs[..., None], 3, axis=-1), ids


class CifarDataSetIterator(_BuiltInIterator):
    """CIFAR-10, NHWC [b, 32, 32, 3] in [0,1] (CifarDataSetIterator.java).
    Reads the standard binary batches (data_batch_N.bin / test_batch.bin:
    3073-byte records, a label byte and 3072 CHW pixel bytes) from
    data_dir() (also under a cifar-10-batches-bin/ subdirectory);
    synthetic fallback."""

    H = W = 32
    CLASSES = 10

    def __init__(self, batch: int = 32, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 123,
                 shuffle: bool = True):
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [p for p in
                 (_find(n, os.path.join("cifar-10-batches-bin", n))
                  for n in names) if p]
        self.synthetic = not paths
        if self.synthetic:
            n = num_examples or (1024 if train else 256)
            imgs, ids = _synthetic_rgb(n, self.H, self.W, self.CLASSES,
                                       seed + (0 if train else 1))
            x = u8_to_unit(imgs)
        else:
            rec = np.concatenate([
                np.frombuffer(_read_raw(p), np.uint8).reshape(-1, 3073)
                for p in paths])
            if num_examples:
                rec = rec[:num_examples]
            ids = rec[:, 0]
            chw = rec[:, 1:].reshape(-1, 3, self.H, self.W)
            x = u8_to_unit(chw.transpose(0, 2, 3, 1))  # NHWC
        self._wrap(x, ids, batch, seed, shuffle)


class SvhnDataSetIterator(_BuiltInIterator):
    """SVHN cropped digits, NHWC [b, 32, 32, 3] (SvhnDataFetcher.java).
    Reads train_32x32.mat / test_32x32.mat (Matlab v5, scipy.io.loadmat)
    from data_dir(), labels 1..10 with 10 meaning 0; synthetic fallback."""

    H = W = 32
    CLASSES = 10

    def __init__(self, batch: int = 32, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 123,
                 shuffle: bool = True):
        path = _find("train_32x32.mat" if train else "test_32x32.mat")
        self.synthetic = path is None
        if self.synthetic:
            n = num_examples or (1024 if train else 256)
            imgs, ids = _synthetic_rgb(n, self.H, self.W, self.CLASSES,
                                       seed + (0 if train else 1))
            x = u8_to_unit(imgs)
        else:
            import io

            from scipy.io import loadmat

            m = loadmat(io.BytesIO(_read_raw(path)))
            imgs = m["X"].transpose(3, 0, 1, 2)  # HWCN -> NHWC
            ids = m["y"].ravel().astype(int) % 10
            if num_examples:
                imgs, ids = imgs[:num_examples], ids[:num_examples]
            x = u8_to_unit(np.ascontiguousarray(imgs))
        self._wrap(x, ids, batch, seed, shuffle)


_IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def _read_image_tree(root: str, h: int, w: int, num_examples: Optional[int],
                     nested: Optional[str] = None):
    """A directory-per-class image tree -> (images u8 [n, h, w, 3], ids,
    class names), or (None, None, names) when it holds no image files.
    A small `num_examples` is spread over the classes (the first
    num_examples % classes take one more), as the JAX package does. Each
    image is decoded by PIL, converted to RGB and resized to (w, h);
    PIL is imported only once image files are found, and ImportError says
    so when it is missing."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    caps = None
    if num_examples and classes:
        base, extra = divmod(num_examples, len(classes))
        caps = [base + (1 if ci < extra else 0)
                for ci in range(len(classes))]
    files = []
    for ci, cname in enumerate(classes):
        if caps is not None and caps[ci] == 0:
            continue
        d = os.path.join(root, cname)
        if nested and os.path.isdir(os.path.join(d, nested)):
            d = os.path.join(d, nested)
        names = [f for f in sorted(os.listdir(d))
                 if f.lower().endswith(_IMAGE_SUFFIXES)]
        if caps is not None:
            names = names[:caps[ci]]
        files += [(ci, os.path.join(d, f)) for f in names]
    if not files:
        return None, None, classes
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{root} holds {len(files)} image files and decoding them needs "
            f"PIL, which is not installed") from e
    imgs = [np.asarray(Image.open(f).convert("RGB").resize((w, h)), np.uint8)
            for _, f in files]
    return np.stack(imgs), np.asarray([ci for ci, _ in files]), classes


class LfwDataSetIterator(_BuiltInIterator):
    """Labeled Faces in the Wild (LfwDataFetcher.java): directory-per-
    person images under data_dir()/lfw, resized to 64x64 RGB, one class per
    directory; synthetic fallback with `num_labels` classes."""

    H = W = 64

    def __init__(self, batch: int = 32, num_examples: Optional[int] = None,
                 num_labels: int = 10, seed: int = 123, shuffle: bool = True):
        root = os.path.join(data_dir(), "lfw")
        imgs = None
        if os.path.isdir(root):
            imgs, ids, classes = _read_image_tree(root, self.H, self.W,
                                                  num_examples)
            if imgs is not None:
                num_labels = len(classes)
        self.synthetic = imgs is None
        self.CLASSES = num_labels
        if self.synthetic:
            imgs, ids = _synthetic_rgb(num_examples or 512, self.H, self.W,
                                       num_labels, seed)
        self._wrap(u8_to_unit(imgs), ids, batch, seed, shuffle)


class TinyImageNetDataSetIterator(_BuiltInIterator):
    """TinyImageNet-200 (TinyImageNetFetcher.java): 64x64 RGB, 200
    classes, tiny-imagenet-200/train/<wnid>/images/*.JPEG under data_dir();
    synthetic fallback."""

    H = W = 64
    CLASSES = 200

    def __init__(self, batch: int = 32, num_examples: Optional[int] = None,
                 seed: int = 123, shuffle: bool = True):
        root = os.path.join(data_dir(), "tiny-imagenet-200", "train")
        imgs = None
        if os.path.isdir(root):
            imgs, ids, _ = _read_image_tree(root, self.H, self.W,
                                            num_examples, nested="images")
        self.synthetic = imgs is None
        if self.synthetic:
            imgs, ids = _synthetic_rgb(num_examples or 1024, self.H, self.W,
                                       self.CLASSES, seed)
        self._wrap(u8_to_unit(imgs), ids, batch, seed, shuffle)


class UciSequenceDataSetIterator(_BuiltInIterator):
    """UCI synthetic control time series (UciSequenceDataSetIterator.java):
    600 univariate length-60 sequences, 6 classes, as sequence DataSets
    [b, 60, 1] with per-sequence one-hot labels; even rows train, odd rows
    test. Reads synthetic_control.data (600 rows x 60 columns, class =
    row // 100) from data_dir(); deterministic synthetic fallback with the
    same six regimes (constant, cyclic, up and down trends, up and down
    shifts)."""

    T = 60
    CLASSES = 6

    def __init__(self, batch: int = 32, train: bool = True, seed: int = 123,
                 shuffle: bool = True):
        path = _find("synthetic_control.data", "synthetic_control.txt")
        self.synthetic = path is None
        if self.synthetic:
            rng = np.random.default_rng(seed)
            t = np.arange(self.T, dtype=np.float32)
            rows, ids = [], []
            for k in range(self.CLASSES):
                for _ in range(100):
                    base = 30 + rng.normal(0, 2, self.T).astype(np.float32)
                    if k == 1:
                        base += 15 * np.sin(2 * np.pi * t
                                            / rng.integers(10, 15))
                    elif k == 2:
                        base += 0.4 * t
                    elif k == 3:
                        base -= 0.4 * t
                    elif k == 4:
                        base += np.where(t > rng.integers(20, 40), 12, 0)
                    elif k == 5:
                        base -= np.where(t > rng.integers(20, 40), 12, 0)
                    rows.append(base)
                    ids.append(k)
            m = np.stack(rows)
            ids = np.asarray(ids)
        else:
            m = np.loadtxt(path, dtype=np.float32)
            ids = np.repeat(np.arange(self.CLASSES), len(m) // self.CLASSES)
        sel = np.arange(len(m)) % 2 == (0 if train else 1)
        self._wrap(m[sel][..., None], ids[sel], batch, seed, shuffle)
