"""DataSet iterators (counterpart of deeplearning4j_tpu/datasets/
iterators.py): DataSetIterator, ListDataSetIterator, ExistingDataSetIterator,
the background-thread prefetch AsyncDataSetIterator (and its MultiDataSet
form) that both runtimes' `fit` wrap around an iterator as the JAX package's
do, the AsyncShield markers that opt out of it, MultipleEpochsIterator,
EarlyTerminationDataSetIterator, SamplingDataSetIterator and
BenchmarkDataSetIterator.

The prefetch producer yields host batches and touches no CUDA state: a
batch goes to the network's device on the consumer, in the runtime's
`_batch`. (The JAX package's device prefetch, a producer-side
`device_put`, is not ported yet.)
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator, Optional, Sequence

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

    def async_supported(self) -> bool:
        """Whether `fit` may wrap this iterator in AsyncDataSetIterator."""
        return True


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


class ExistingDataSetIterator(DataSetIterator):
    """Wrap a python iterable of DataSets."""

    def __init__(self, iterable: Sequence[DataSet]):
        self._src = list(iterable)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self._src):
            raise StopIteration
        d = self._src[self._pos]
        self._pos += 1
        return d

    def batch_size(self):
        return self._src[0].num_examples() if self._src else 0


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue
    (AsyncDataSetIterator.java:30-64). Wraps any DataSetIterator; `fit`
    wraps one automatically, as MultiLayerNetwork.fit does.

    The producer thread is named (``AsyncDataSetIterator-prefetch-N``) and
    daemonized. Each producer carries a stop event: ``reset()`` and
    ``shutdown()`` signal it, drain the queue to its sentinel and join, so
    a stale producer never feeds a replaced queue and no queue holds two
    sentinels. Every wait of the teardown is bounded. An error raised by
    the underlying iterator ends the stream and is raised again on the
    consumer. `queue_size` None reads `DL4J_TPU_PREFETCH_DEPTH` (default 4)
    at each start."""

    _END = object()
    _ids = itertools.count()

    def __init__(self, underlying: DataSetIterator,
                 queue_size: Optional[int] = None):
        self.underlying = underlying
        self.queue_size = queue_size
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._error: Optional[BaseException] = None

    def prefetch_depth(self) -> int:
        """The bounded queue's depth for the next producer start."""
        if self.queue_size is not None:
            return max(1, int(self.queue_size))
        from deeplearning4j_tpu_torch.util import envflags

        return max(1, envflags.int_value("DL4J_TPU_PREFETCH_DEPTH", 4))

    def _start(self):
        q = self._q = queue.Queue(maxsize=self.prefetch_depth())
        stop = self._stop = threading.Event()
        self._error = None

        def worker():
            try:
                for d in self.underlying:
                    while not stop.is_set():
                        try:
                            q.put(d, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        break
            except BaseException as e:  # raised again on the consumer
                self._error = e
            finally:
                # the sentinel always lands: on cancellation the resetter
                # drains this queue, otherwise the consumer pulls from it
                while True:
                    try:
                        q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            try:  # make room: nobody reads this queue
                                q.get_nowait()
                            except queue.Empty:
                                pass

        self._thread = threading.Thread(
            target=worker, daemon=True,
            name=f"{type(self).__name__}-prefetch-{next(self._ids)}")
        self._thread.start()

    def _stop_worker(self):
        """Signal, drain to the sentinel and join the producer (a no-op
        when none runs): no stale producer survives, and the next
        `_start` begins from a fresh queue."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        while t.is_alive():
            try:
                if self._q.get(timeout=0.1) is self._END:
                    break
            except queue.Empty:
                continue
        t.join(timeout=10.0)
        self._thread = None
        self._stop = None

    def reset(self):
        self._stop_worker()
        self._start()

    def shutdown(self):
        """Stop the producer thread and release the queue. Idempotent: safe
        to call again or on an iterator never started; a later iteration
        starts a fresh producer."""
        self._stop_worker()
        self._q = None

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if self._q is None:
            self._start()
        item = self._q.get()
        if item is self._END:
            # put back, so a later next() sees StopIteration again instead
            # of blocking on a queue whose producer has exited
            self._q.put(self._END)
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def batch_size(self):
        return self.underlying.batch_size()

    def total_outcomes(self):
        return self.underlying.total_outcomes()


def prefetching(it: DataSetIterator,
                queue_size: Optional[int] = None) -> DataSetIterator:
    """`it` wrapped in AsyncDataSetIterator where it allows it and is not
    one already (the rule of the JAX package's fit paths); else `it`."""
    if it.async_supported() and not isinstance(it, AsyncDataSetIterator):
        return AsyncDataSetIterator(it, queue_size)
    return it


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an iterator for N epochs (MultipleEpochsIterator.java)."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self.epochs = epochs
        self.underlying = underlying
        self._epoch = 0
        self._inner: Optional[Iterator] = None

    def reset(self):
        self._epoch = 0
        self._inner = iter(self.underlying)

    def __next__(self):
        if self._inner is None:
            self.reset()
        while True:
            try:
                return next(self._inner)
            except StopIteration:
                self._epoch += 1
                if self._epoch >= self.epochs:
                    raise
                self._inner = iter(self.underlying)

    def batch_size(self):
        return self.underlying.batch_size()


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Cap the number of minibatches (EarlyTerminationDataSetIterator.java)."""

    def __init__(self, underlying: DataSetIterator, max_batches: int):
        self.underlying = underlying
        self.max_batches = max_batches
        self._count = 0

    def reset(self):
        self._count = 0
        self.underlying.reset()

    def __iter__(self):
        self.reset()
        self._inner = iter(self.underlying)
        return self

    def __next__(self):
        if self._count >= self.max_batches:
            raise StopIteration
        self._count += 1
        return next(self._inner)

    def batch_size(self):
        return self.underlying.batch_size()


class SamplingDataSetIterator(DataSetIterator):
    """Sample `batch` examples with replacement from a DataSet each step
    (SamplingDataSetIterator.java); numpy's generator from `seed`, so the
    port draws the JAX package's rows."""

    def __init__(self, data: DataSet, batch: int, total_batches: int,
                 seed: int = 0):
        self.data = data
        self.batch = batch
        self.total_batches = total_batches
        self._rng = np.random.default_rng(seed)
        self._count = 0

    def reset(self):
        self._count = 0

    def __next__(self):
        if self._count >= self.total_batches:
            raise StopIteration
        self._count += 1
        idx = self._rng.integers(0, self.data.num_examples(), self.batch)
        return DataSet(self.data.features[idx], self.data.labels[idx])

    def batch_size(self):
        return self.batch


class BenchmarkDataSetIterator(DataSetIterator):
    """Synthetic batches of a fixed shape for throughput measurement
    without I/O (impl/BenchmarkDataSetIterator.java:20): one batch drawn
    from `seed` by numpy (the JAX package's values) and handed out
    `total_batches` times."""

    def __init__(self, feature_shape: Sequence[int], num_classes: int,
                 total_batches: int = 100, seed: int = 0,
                 label_shape: Optional[Sequence[int]] = None):
        rng = np.random.default_rng(seed)
        feats = rng.standard_normal(tuple(feature_shape), dtype=np.float32)
        if label_shape is None:
            batch = feature_shape[0]
            ids = rng.integers(0, num_classes, batch)
            labels = np.zeros((batch, num_classes), np.float32)
            labels[np.arange(batch), ids] = 1.0
        else:
            labels = rng.standard_normal(tuple(label_shape)).astype(
                np.float32)
        self._ds = DataSet(feats, labels)
        self.total_batches = total_batches
        self._count = 0

    def reset(self):
        self._count = 0

    def __next__(self):
        if self._count >= self.total_batches:
            raise StopIteration
        self._count += 1
        return self._ds

    def batch_size(self):
        return self._ds.num_examples()

    def total_outcomes(self):
        return int(self._ds.labels.shape[-1])


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """Background prefetch over MultiDataSet streams
    (AsyncMultiDataSetIterator.java): the same bounded queue; the producer
    does not look at what it carries."""


class AsyncShieldDataSetIterator(DataSetIterator):
    """Marker wrapper: `fit` does not wrap this iterator in async prefetch
    (AsyncShieldDataSetIterator.java), for iterators that are not
    thread-safe or prefetch on their own."""

    def __init__(self, underlying: DataSetIterator):
        self.underlying = underlying

    def reset(self):
        self.underlying.reset()

    def __iter__(self):
        self.underlying.reset()
        return self

    def __next__(self):
        return next(self.underlying)

    def batch_size(self):
        return self.underlying.batch_size()

    def total_outcomes(self):
        return self.underlying.total_outcomes()

    def async_supported(self):
        return False


class AsyncShieldMultiDataSetIterator(AsyncShieldDataSetIterator):
    """MultiDataSet form of the async shield
    (AsyncShieldMultiDataSetIterator.java)."""
