"""Global precision policy (counterpart of deeplearning4j_tpu/dtypes.py).

Parameters, BatchNorm statistics and losses live in float32. The JAX package
runs its matmuls and convolutions as bf16 passes on the TPU's matrix unit
unless `full_precision()` asks for exact float32. On the card the same
policy maps onto TF32, the tensor cores' reduced-precision float32 (about
three decimal digits):

    reduced precision (default)   TF32 allowed for cuDNN convolutions and
                                  for matmuls
    full_precision()              TF32 off for both: exact float32

`ops/linear.py` applies the policy to PyTorch's two switches
(`torch.backends.cudnn.allow_tf32`, `torch.backends.cuda.matmul.allow_tf32`)
right before every dot and convolution, so the switches always say what the
policy says. On the CPU neither switch changes a result.

`set_mixed_precision(True)` gives bf16 activations: dot/conv operands are
cast to bfloat16 and produce bfloat16 outputs, while params, BN statistics
and losses stay float32, as in the JAX package.
"""
from __future__ import annotations

import contextlib

import torch

_reduced_matmul = True


def matmul_precision_dtype():
    """bf16 while reduced-precision contractions are allowed (TF32 on the
    card), None under full precision. Same contract as the JAX package."""
    return torch.bfloat16 if _reduced_matmul else None


@contextlib.contextmanager
def full_precision():
    """Force exact float32 dot/conv (TF32 off)."""
    global _reduced_matmul
    prev = _reduced_matmul
    _reduced_matmul = False
    try:
        yield
    finally:
        _reduced_matmul = prev


# --- mixed-precision activations ------------------------------------------
_mixed_activations = False


def mixed_precision() -> bool:
    return _mixed_activations and _reduced_matmul


def set_mixed_precision(enabled: bool) -> None:
    """bf16 activations / f32 params+stats+loss (a la AMP)."""
    global _mixed_activations
    _mixed_activations = bool(enabled)


@contextlib.contextmanager
def mixed():
    global _mixed_activations
    prev = _mixed_activations
    _mixed_activations = True
    try:
        yield
    finally:
        _mixed_activations = prev
