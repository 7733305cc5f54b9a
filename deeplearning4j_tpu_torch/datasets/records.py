"""Record readers: the DataVec-bridge ingestion path (counterpart of
deeplearning4j_tpu/datasets/records.py; SURVEY.md §2.2 "DataVec bridge":
RecordReaderDataSetIterator and SequenceRecordReaderDataSetIterator over
datavec's CSV and image readers). A record is a 1-D float vector, a
sequence record a [t, f] matrix.

The JAX package parses with its native C++ kernels where a toolchain is
present; the port parses with numpy, the JAX module's own path without
one: the same numbers (bad or missing fields NaN, rows cut or padded with
NaN to the first row's width). A file whose rows are all complete and
numeric takes a vectorized parse.

    reader = CSVRecordReader("iris.csv", skip_lines=1)
    it = RecordReaderDataSetIterator(reader, batch=32, label_index=4,
                                     num_classes=3)
    net.fit(it)
"""
from __future__ import annotations

import glob as globmod
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


# ---------------------------------------------------------------- readers
class RecordReader:
    """Iterates 1-D float records (datavec RecordReader's role)."""

    def records(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def reset(self):
        pass


class SequenceRecordReader:
    """Iterates [t, f] sequences (datavec SequenceRecordReader's role)."""

    def sequences(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def reset(self):
        pass


def _parse_fields(lines: List[str], delimiter: str) -> np.ndarray:
    """Field by field: bad fields NaN, rows to the first row's width."""
    rows: List[List[float]] = []
    for line in lines:
        vals = []
        for fld in line.split(delimiter):
            try:
                vals.append(float(fld))
            except ValueError:
                vals.append(float("nan"))
        rows.append(vals)
    width = len(rows[0])
    fixed = [r[:width] + [float("nan")] * (width - len(r)) for r in rows]
    return np.asarray(fixed, np.float32)


def parse_csv_bytes(data: bytes, skip_lines: int = 0,
                    delimiter: str = ",") -> np.ndarray:
    """CSV bytes as a float32 [rows, cols] matrix: the first `skip_lines`
    lines and blank lines skipped, each field through Python's float
    (then float32), a bad or missing field NaN, every row cut or padded to
    the first row's width."""
    lines = [line for i, line in enumerate(
        data.decode("utf-8", "replace").splitlines())
        if i >= skip_lines and line.strip()]
    if not lines:
        return np.zeros((0, 0), np.float32)
    width = lines[0].count(delimiter) + 1
    if all(line.count(delimiter) + 1 == width for line in lines):
        try:
            # float64 first: Python's float, then one rounding to float32
            return np.array([line.split(delimiter) for line in lines],
                            dtype=np.float64).astype(np.float32)
        except ValueError:
            pass
    return _parse_fields(lines, delimiter)


class CSVRecordReader(RecordReader):
    """One record per CSV line (datavec CSVRecordReader)."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._data: Optional[np.ndarray] = None

    def load(self) -> np.ndarray:
        if self._data is None:
            with open(self.path, "rb") as f:
                self._data = parse_csv_bytes(f.read(), self.skip_lines,
                                             self.delimiter)
        return self._data

    def records(self):
        yield from self.load()


class CSVSequenceRecordReader(SequenceRecordReader):
    """One sequence per FILE, one time step per line (datavec
    CSVSequenceRecordReader). `paths` is a glob pattern (sorted) or a
    list."""

    def __init__(self, paths, skip_lines: int = 0, delimiter: str = ","):
        if isinstance(paths, str):
            self.paths = sorted(globmod.glob(paths))
        else:
            self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def sequences(self):
        for p in self.paths:
            with open(p, "rb") as f:
                yield parse_csv_bytes(f.read(), self.skip_lines,
                                      self.delimiter)


class CollectionRecordReader(RecordReader):
    """Records from an in-memory array or list (datavec
    CollectionRecordReader)."""

    def __init__(self, rows):
        self.rows = np.asarray(rows, np.float32)

    def records(self):
        yield from self.rows


class ImageRecordReader(RecordReader):
    """Images from directories, the label the parent directory's name
    (datavec ImageRecordReader with ParentPathLabelGenerator; labels
    numbered in sorted order). Reads P6 PPM and .npy files, and other
    formats when PIL is importable; each image resized by nearest
    neighbour to height x width x channels and scaled by 1/255. A record
    is the flattened [h * w * c] image with the label appended (so it
    composes with RecordReaderDataSetIterator(label_index=-1))."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 root: Optional[str] = None, paths: Optional[Sequence] = None):
        self.h, self.w, self.c = height, width, channels
        if root is not None:
            paths = sorted(
                p for p in globmod.glob(os.path.join(root, "*", "*"))
                if os.path.isfile(p))
        self.paths = list(paths or [])
        labels = sorted({os.path.basename(os.path.dirname(p))
                         for p in self.paths})
        self.label_index = {l: i for i, l in enumerate(labels)}

    def num_labels(self) -> int:
        return len(self.label_index)

    def _decode(self, path: str) -> np.ndarray:
        if path.endswith(".ppm"):
            img = read_ppm(path)
        elif path.endswith(".npy"):
            img = np.load(path)
        else:
            try:
                from PIL import Image
            except ImportError as e:
                raise ValueError(
                    f"cannot decode {path}: PIL unavailable; use .ppm/.npy"
                ) from e
            img = np.asarray(Image.open(path))
        img = _resize_nearest(img, self.h, self.w, self.c)
        return img.astype(np.float32) / 255.0

    def records(self):
        for p in self.paths:
            img = self._decode(p).reshape(-1)
            label = float(self.label_index[os.path.basename(
                os.path.dirname(p))])
            yield np.concatenate([img, [label]]).astype(np.float32)


def read_ppm(path: str) -> np.ndarray:
    """A binary (P6) PPM image as uint8 [h, w, 3]."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path}: not a P6 PPM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    if maxval != 255:
        data = (data.astype(np.float32) * (255.0 / maxval)).astype(np.uint8)
    return data.reshape(h, w, 3)


def _resize_nearest(img: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > c:
        img = img[:, :, :c]
    elif img.shape[2] < c:
        img = np.repeat(img, c, axis=2)[:, :, :c]
    if img.shape[:2] != (h, w):
        yi = (np.arange(h) * img.shape[0] / h).astype(int)
        xi = (np.arange(w) * img.shape[1] / w).astype(int)
        img = img[yi][:, xi]
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------- iterators
def _one_hot(ids: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(ids), n), np.float32)
    out[np.arange(len(ids)), ids.astype(int)] = 1.0
    return out


class RecordReaderDataSetIterator(DataSetIterator):
    """Records as DataSet batches (datasets/datavec/
    RecordReaderDataSetIterator.java):
      classification: the label_index column one-hot (num_classes);
      regression:     the columns [label_index, label_index_to] are the
                      targets;
      unsupervised:   label_index None, the labels are the features.
    label_index may be negative (-1 is the last column)."""

    def __init__(self, reader: RecordReader, batch: int = 32,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 label_index_to: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self.batch = batch
        self.label_index = label_index
        self.num_classes = num_classes
        self.label_index_to = label_index_to
        self.regression = regression
        self._it: Optional[Iterator] = None

    def reset(self):
        self.reader.reset()
        self._it = None

    def _make(self, rows: List[np.ndarray]) -> DataSet:
        m = np.stack(rows)
        li = self.label_index
        if li is None:
            return DataSet(m.astype(np.float32), m.astype(np.float32))
        if li < 0:
            li += m.shape[1]
        if self.regression:
            hi = (self.label_index_to if self.label_index_to is not None
                  else li) + 1
            y = m[:, li:hi]
            x = np.concatenate([m[:, :li], m[:, hi:]], axis=1)
        else:
            if not self.num_classes:
                raise ValueError("classification needs num_classes")
            y = _one_hot(m[:, li], self.num_classes)
            x = np.concatenate([m[:, :li], m[:, li + 1:]], axis=1)
        return DataSet(x.astype(np.float32), y.astype(np.float32))

    def __next__(self) -> DataSet:
        if self._it is None:
            self._it = self.reader.records()
        rows = []
        for rec in self._it:
            rows.append(np.asarray(rec, np.float32))
            if len(rows) == self.batch:
                break
        if not rows:
            self._it = None
            raise StopIteration
        return self._make(rows)

    def batch_size(self):
        return self.batch

    def total_outcomes(self):
        return self.num_classes or 0


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequences as padded, masked [b, t, f] DataSet batches (datasets/
    datavec/SequenceRecordReaderDataSetIterator.java): each batch padded on
    the right to its longest sequence, the features and labels masks 1
    on the live steps. The label_index column is one-hot (num_classes),
    or the regression target."""

    def __init__(self, reader: SequenceRecordReader, batch: int = 8,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self.batch = batch
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self._it: Optional[Iterator] = None

    def reset(self):
        self.reader.reset()
        self._it = None

    def __next__(self) -> DataSet:
        if self._it is None:
            self._it = self.reader.sequences()
        seqs = []
        for s in self._it:
            seqs.append(np.asarray(s, np.float32))
            if len(seqs) == self.batch:
                break
        if not seqs:
            self._it = None
            raise StopIteration
        tmax = max(s.shape[0] for s in seqs)
        li = self.label_index
        ncols = seqs[0].shape[1]
        if li < 0:
            li += ncols
        ydim = self.num_classes if not self.regression else 1
        b = len(seqs)
        x = np.zeros((b, tmax, ncols - 1), np.float32)
        y = np.zeros((b, tmax, ydim), np.float32)
        mask = np.zeros((b, tmax), np.float32)
        for i, s in enumerate(seqs):
            t = s.shape[0]
            x[i, :t] = np.concatenate([s[:, :li], s[:, li + 1:]], axis=1)
            if self.regression:
                y[i, :t, 0] = s[:, li]
            else:
                y[i, :t] = _one_hot(s[:, li], self.num_classes)
            mask[i, :t] = 1.0
        return DataSet(x, y, features_mask=mask, labels_mask=mask)

    def batch_size(self):
        return self.batch
