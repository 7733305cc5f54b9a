"""Threshold gradient compression, the analogue of ND4J's
ThresholdCompression that EncodingHandler uses (counterpart of
deeplearning4j_tpu/parallel/compression.py).

Reference: optimize/solvers/accumulation/EncodingHandler.java:26-114 —
adaptive threshold sparse encoding of gradient updates, the residual kept
locally (the gradient minus what was sent), the threshold decayed when
the updates are sparse and raised when they are dense.

`threshold_encode` keeps a fixed capacity k per round (the JAX package's
static shape): the k largest magnitudes, ties to the lower index as
`lax.top_k` takes them, of which those at or above the threshold are
sent as sign(g) * threshold (one bit and the shared threshold, as the
reference encodes). Everything runs in torch on the gradients' device;
`EncodingHandler` keeps its residuals there. With `use_host_codec` the
encoding is the exact-density form (every entry at or above the
threshold, no capacity), which the JAX package runs through its native
codec or, without a toolchain, numpy; the port computes that form with
torch (the native codec is ROADMAP A.11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np
import torch

PyTree = Any


def threshold_encode(flat_grad: torch.Tensor, threshold: float, k: int):
    """(indices[k], values[k], residual): the k largest |g| (ties to the
    lower index), those >= threshold sent as sign(g) * threshold, unused
    slots with index -1 and value 0; the residual is g minus what was
    sent."""
    g = flat_grad
    mags = g.abs()
    vals, idx = torch.sort(mags, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    live = vals >= threshold
    sel_idx = torch.where(live, idx, torch.full_like(idx, -1))
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    sel_vals = torch.where(live, torch.sign(g[idx]) * threshold, zero)
    delta = threshold_decode(sel_idx, sel_vals, g.numel())
    return sel_idx, sel_vals, g - delta


def threshold_decode(indices: torch.Tensor, values: torch.Tensor,
                     size: int) -> torch.Tensor:
    """The dense vector of `size` the message stands for (slots with index
    -1 add nothing)."""
    out = torch.zeros(size, dtype=values.dtype, device=values.device)
    live = indices >= 0
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    return out.index_add_(0, indices.clamp_min(0),
                          torch.where(live, values, zero))


def _flatten(tree, prefix=""):
    """(path, leaf) pairs of nested dicts (keys sorted, as a JAX pytree
    orders them) and lists, paths joined by '/'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return leaves[prefix[:-1]]


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


@dataclass
class EncodingHandler:
    """Residual accumulation and the adaptive threshold
    (EncodingHandler.java's decay and boost)."""

    threshold: float = 1e-3
    min_threshold: float = 1e-5
    decay: float = 0.95
    boost: float = 1.2
    target_density: float = 1e-2
    capacity_fraction: float = 0.05
    # the exact-density encoding (no capacity) instead of the fixed-k one
    use_host_codec: bool = False
    _residuals: Dict[str, torch.Tensor] = field(default_factory=dict)

    def _encode_leaf(self, g: torch.Tensor, k: int):
        """(idx, vals, residual, delta) of one flat leaf."""
        if self.use_host_codec:
            idx = torch.nonzero(g.abs() >= self.threshold)[:, 0]
            vals = torch.sign(g[idx]) * self.threshold
            delta = threshold_decode(idx, vals, g.numel())
            return idx, vals, g - delta, delta
        idx, vals, residual = threshold_encode(g, self.threshold,
                                               min(k, g.numel()))
        return idx, vals, residual, threshold_decode(idx, vals, g.numel())

    def encode_tree(self, grads: PyTree) -> Tuple[dict, PyTree]:
        """({leaf path: (indices, values, size)}, the decoded delta tree):
        the deltas are what peers would apply; the residuals stay here."""
        messages, deltas = {}, {}
        total, sent = 0, 0
        for key, leaf in _flatten(grads):
            t = _as_tensor(leaf)
            g = t.reshape(-1).to(torch.float32)
            res = self._residuals.get(key)
            if res is not None:
                g = g + res
            k = max(1, int(g.numel() * self.capacity_fraction))
            idx, vals, residual, delta = self._encode_leaf(g, k)
            self._residuals[key] = residual
            messages[key] = (idx, vals, g.numel())
            deltas[key] = delta.reshape(t.shape)
            total += g.numel()
            sent += int((idx >= 0).sum())
        # adaptive threshold: too dense -> raise, too sparse -> decay
        density = sent / max(total, 1)
        if density > self.target_density:
            self.threshold *= self.boost
        else:
            self.threshold = max(self.min_threshold,
                                 self.threshold * self.decay)
        return messages, _rebuild(grads, deltas)

    @staticmethod
    def decode_messages(messages: dict, like: PyTree) -> PyTree:
        """The dense tree the messages stand for, shaped as `like`."""
        out = {}
        for key, leaf in _flatten(like):
            idx, vals, size = messages[key]
            out[key] = threshold_decode(idx, vals, size).reshape(
                tuple(leaf.shape))
        return _rebuild(like, out)
