"""Bucketed padded batch shapes — a finite set of shapes for serving (the
port's own copy of deeplearning4j_tpu/serving/buckets.py).

A server that dispatches every coalesced batch at its exact row count sees
an unbounded stream of shapes, and each new one pays first-call costs in
the tail latency: on the card, cuDNN's algorithm choice and fresh allocator
blocks (in the JAX package, a compile). The fix is the classic one
(TF-Serving's batching layer, PAPERS.md 1605.08695): quantize batch sizes
into a SMALL fixed set of buckets, pad every batch up to its bucket, and
warm each bucket once before traffic arrives.

`BucketSpec` owns the size set:

  * sizes are powers of two from `align` up to `max_batch`, each rounded
    up to a multiple of `align` (the data-mesh axis length — a padded
    batch must still shard evenly), deduplicated, sorted;
  * `bucket_for(n)` is the smallest bucket >= n, or None when n exceeds
    the largest bucket (the caller dispatches such a request alone at
    the largest bucket's multiple — see `pad_rows`);
  * `pad_rows(x, target)` pads by repeating the final row (repeats of
    real data keep every padded row inside the model's input
    distribution, so BatchNorm-style state sees nothing exotic), and the
    dispatcher slices the first n rows of the output back out.

Pure numpy + stdlib.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _round_up(n: int, align: int) -> int:
    return ((int(n) + align - 1) // align) * align


class BucketSpec:
    """The finite set of padded batch sizes a server dispatches at."""

    def __init__(self, max_batch: int, align: int = 1,
                 sizes: Optional[Sequence[int]] = None):
        self.align = max(1, int(align))
        self.max_batch = _round_up(max(1, int(max_batch)), self.align)
        if sizes is None:
            out = set()
            b = self.align
            while b < self.max_batch:
                out.add(_round_up(b, self.align))
                b *= 2
            out.add(self.max_batch)
            sizes = out
        self.sizes: Tuple[int, ...] = tuple(sorted(
            _round_up(s, self.align) for s in set(int(s) for s in sizes)
            if s > 0))
        if not self.sizes:
            raise ValueError("BucketSpec needs at least one bucket size")

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket >= n; None when n overflows the largest
        bucket (dispatch alone, padded to an align multiple)."""
        for s in self.sizes:
            if n <= s:
                return s
        return None

    def padded_size(self, n: int) -> int:
        """The row count a batch of n real rows dispatches at: its
        bucket, or (oversize) the next align multiple of n itself."""
        b = self.bucket_for(n)
        return b if b is not None else _round_up(n, self.align)

    def __repr__(self) -> str:
        return (f"BucketSpec(sizes={self.sizes}, align={self.align})")


def pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    """Pad x's leading axis up to `target` rows by repeating the last
    row; returns x unchanged when already at target."""
    n = x.shape[0]
    if n == target:
        return x
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    return np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)],
                          axis=0)


def signature(x: np.ndarray) -> Tuple:
    """The coalescing key: requests concatenate into one batch only when
    their trailing shape AND dtype agree (a mismatched-rank request must
    fail alone, never poison a coalesced batch)."""
    return (tuple(x.shape[1:]), str(x.dtype))
