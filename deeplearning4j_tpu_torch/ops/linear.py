"""Matmul / conv primitives (counterpart of deeplearning4j_tpu/ops/linear.py).

Layouts at these functions are the JAX package's: NHWC activations. The
conv weight is held as OIHW in channels_last memory (see `Conv2D`); the
activation is handed to cuDNN as a `permute(0, 3, 1, 2)` view of the NHWC
memory, which is already channels_last, so no copy is made on the way in,
and the result permuted back is NHWC-contiguous again.

`conv2d_transpose` takes the HWIO kernel of the interchange layout.

Precision follows `dtypes`: each call sets PyTorch's TF32 switches for
cuDNN convolutions and matmuls from the policy first (TF32 allowed by
default, off under `dtypes.full_precision()`); under
`dtypes.set_mixed_precision(True)` operands are cast to bfloat16.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes

Padding = Union[str, Sequence[Tuple[int, int]]]


def _apply_precision() -> None:
    tf32 = dtypes.matmul_precision_dtype() is not None
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _mixed_cast(x, w):
    """bf16 operands under the mixed-precision policy."""
    if dtypes.mixed_precision() and x.dtype in (torch.float32, torch.bfloat16):
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    return x, w


def bias_add(z: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """z + b in z's dtype (a bf16 activation stays bf16 under the mixed
    policy, where params are f32)."""
    return z + b.to(z.dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, w stored [n_in, n_out] as in the JAX package."""
    x, w = _mixed_cast(x, w)
    _apply_precision()
    return torch.matmul(x, w)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the JAX package's plain `@` computes it: both operands in
    their promoted dtype (bfloat16 @ float32 is float32), no mixed cast;
    the TF32 switch set from the policy, as for `dot`."""
    dt = torch.promote_types(a.dtype, b.dtype)
    _apply_precision()
    return torch.matmul(a.to(dt), b.to(dt))


def same_padding(size: int, kernel: int, stride: int,
                 dilation: int = 1) -> Tuple[int, int]:
    """XLA 'SAME' padding for one spatial axis: output ceil(size/stride),
    the odd pixel on the high side (a 7x7/2 conv on 224 pads (2, 3))."""
    eff_k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff_k - size, 0)
    return total // 2, total - total // 2


def resolve_padding(x_nhwc: torch.Tensor, kernel: Tuple[int, int],
                    stride: Tuple[int, int], padding: Padding,
                    dilation: Tuple[int, int] = (1, 1)):
    """'SAME' | 'VALID' | [(lo, hi), (lo, hi)] -> [(lo, hi), (lo, hi)]."""
    if padding == "SAME":
        return [same_padding(x_nhwc.shape[1], kernel[0], stride[0],
                             dilation[0]),
                same_padding(x_nhwc.shape[2], kernel[1], stride[1],
                             dilation[1])]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    return [tuple(p) for p in padding]


def pad_nhwc(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad H and W of an NHWC tensor; the result is NHWC-contiguous."""
    (hl, hh), (wl, wh) = pads
    return F.pad(x, (0, 0, wl, wh, hl, hh), value=value)


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    stride: Tuple[int, int],
    padding: Padding,
    dilation: Tuple[int, int] = (1, 1),
    groups: int = 1,
) -> torch.Tensor:
    """NHWC conv with an OIHW (channels_last) kernel -> NHWC-contiguous.
    `padding` is 'SAME', 'VALID', or [(lo, hi), (lo, hi)]; unequal sides
    are padded explicitly, since cuDNN pads symmetrically."""
    x, kernel = _mixed_cast(x, kernel)
    _apply_precision()
    kh, kw = kernel.shape[2], kernel.shape[3]
    (hl, hh), (wl, wh) = resolve_padding(x, (kh, kw), stride, padding,
                                         dilation)
    if hl != hh or wl != wh:
        x = pad_nhwc(x, [(hl, hh), (wl, wh)])
        hl = wl = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, None, stride, (hl, wl),
                 dilation, groups)
    # cuDNN writes channels_last for a channels_last input, so this is a
    # view; contiguous() only copies if a backend chose another layout
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose_padding(kernel: int, stride: int, padding) -> Tuple[int, int]:
    """lax.conv_transpose's (lo, hi) pads of the stride-dilated input for
    one axis: 'SAME' (output size * stride), 'VALID', or an explicit
    (lo, hi), which lax puts onto the dilated input as it is."""
    if padding == "SAME":
        total = kernel + stride - 2
        lo = kernel - 1 if stride > kernel - 1 else -(-total // 2)
        return lo, total - lo
    if padding == "VALID":
        return kernel - 1, stride - 1 + max(kernel - stride, 0)
    return int(padding[0]), int(padding[1])


def conv2d_transpose(
    x: torch.Tensor,
    kernel: torch.Tensor,
    stride: Tuple[int, int],
    padding: Padding,
) -> torch.Tensor:
    """NHWC transposed conv (Deconvolution2D) with an HWIO [kh, kw, cin,
    cout] kernel -> NHWC-contiguous, as the JAX package's
    `lax.conv_transpose` (transpose_kernel=False): a correlation of the
    stride-dilated input, padded by `conv_transpose_padding`, with the
    kernel as it is. cuDNN's transposed conv correlates with the kernel
    flipped in both spatial axes and pads the dilated input by k - 1 on
    each side, so it is given the flipped kernel as [cin, cout, kh, kw]
    and its result is cropped (or zero-padded) to lax's pads."""
    x, kernel = _mixed_cast(x, kernel)
    _apply_precision()
    kh, kw = kernel.shape[0], kernel.shape[1]
    if isinstance(padding, str):
        pads = [conv_transpose_padding(kh, stride[0], padding),
                conv_transpose_padding(kw, stride[1], padding)]
    else:
        pads = [tuple(p) for p in padding]
    w = kernel.permute(2, 3, 0, 1).flip(2, 3)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None, stride)
    (hl, hh), (wl, wh) = pads
    # F.pad crops where a pad is negative
    y = F.pad(y, (wl - kw + 1, wh - kw + 1, hl - kh + 1, hh - kh + 1))
    return y.permute(0, 2, 3, 1).contiguous()
