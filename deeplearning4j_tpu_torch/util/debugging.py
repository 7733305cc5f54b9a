"""Numerical-safety and aliasing debug hooks (counterpart of
deeplearning4j_tpu/util/debugging.py): the JAX package's switches on the
port's runtime, behind the same three names.

    with debugging.nan_checks():
        net.fit(...)          # the first op that produces a NaN raises

    debugging.assert_finite(net.params, "params after fit")
"""
from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# not checked: ops whose outputs are uninitialized memory until something
# writes them (a hand-written kernel's outputs among them), and the ops
# that place host data or move it between devices (jax_debug_nans does not
# check device_put either)
_UNCHECKED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_", "lift_fresh",
                        "lift_fresh_copy", "to", "_to_copy"})

_nan_checks_on = False


class _NanCheckMode(TorchDispatchMode):
    """Checks every floating-point output of every torch op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _nan_checks_on or \
                func.overloadpacket.__name__ in _UNCHECKED:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def nan_checks(enabled: bool = True):
    """The port's jax_debug_nans: inside the block every torch op's
    floating-point output is checked (a TorchDispatchMode), and the first
    op that produces a NaN raises FloatingPointError naming the op. The
    check syncs with the card after every op; test/debug only. A
    hand-written kernel writes its outputs outside torch's dispatch, so a
    NaN it produces is seen at the next torch op that reads it (or at
    one derived from it). `enabled=False` turns the checks off inside an
    enclosing block; the previous state comes back on exit. The ops
    checked are those of the entering thread and of the backward passes
    it starts (torch hands its dispatch modes to autograd's threads)."""
    global _nan_checks_on
    prev = _nan_checks_on
    _nan_checks_on = bool(enabled)
    try:
        if enabled and not prev:
            with _NanCheckMode():
                yield
        else:
            yield
    finally:
        _nan_checks_on = prev


@contextlib.contextmanager
def donation_checks(enabled: bool = True):
    """The nearest torch meaning of the JAX package's donated-buffer
    checks. Where JAX donates the params and updater state to a train step
    (and reusing a donated array raises under jax_enable_checks), the port
    updates them in place; the torch hazard that corresponds is a tensor
    that autograd saved for the backward and that an in-place op
    overwrote before the backward read it. Torch refuses that backward
    always (RuntimeError, "modified by an inplace operation"); inside this
    block autograd's anomaly mode is on (`torch.autograd.
    set_detect_anomaly`), so the refusal also names the forward call that
    saved the tensor, and a backward function that returns NaN raises
    RuntimeError naming it. The previous anomaly setting comes back on
    exit."""
    with torch.autograd.set_detect_anomaly(bool(enabled)):
        yield


def assert_finite(tree: Any, what: str = "tree") -> None:
    """Host-side finite check over nested dicts, lists and tuples of
    tensors or arrays (params, gradients, updater slots): raises ValueError
    naming the first leaf with a non-finite value, its path written as the
    JAX package writes it ('layer_0/W': dict keys sorted, list indices)."""
    from deeplearning4j_tpu_torch.models.serialization import _key_parts

    for name, leaf in _key_parts(tree):
        if isinstance(leaf, torch.Tensor):
            bad = ~torch.isfinite(leaf.detach())
            n_bad, size = int(bad.sum()), leaf.numel()
        else:
            arr = np.asarray(leaf)
            n_bad, size = int((~np.isfinite(arr)).sum()), arr.size
        if n_bad:
            raise ValueError(
                f"{what}: non-finite values in leaf '{name}' "
                f"({n_bad}/{size} elements)")
