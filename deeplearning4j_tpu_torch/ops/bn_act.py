"""Fused BatchNorm epilogue y = act(x * scale + shift), act in {relu, identity}.

Replaces the TPU kernel `_bn_act_kernel` of
deeplearning4j_tpu/ops/pallas_kernels.py (its `pl.pallas_call` is in
`_bn_act_impl`). Every `conv_bn` block of ResNet-50 reaches it through
`BatchNorm._affine_act`: 53 calls per forward.

The CUDA kernel (csrc/bn_act.cu) is bound by device-memory bandwidth: it
reads x and writes y once, 2 * rows * c * itemsize bytes, and does two
operations per element, so its least time on an H100 SXM is those bytes over
3.35 TB/s (0.81 ms for the 53 calls of one float32 forward at batch 32,
224x224). Its design for that bound (16-byte vector accesses along the
channel axis, scale/shift loaded once per thread, a grid-stride walk over
any row count) is described in the source.

`bn_act` launches the kernel for a CUDA tensor and raises on anything the
kernel does not take; it never copies and never falls back. For a tensor on
the CPU it computes `bn_act_reference`, the plain version the kernel is held
against. Gradients recompute through the plain version, as the TPU kernel's
custom VJP does.
"""
from __future__ import annotations

import ctypes
import threading

import torch

ACTS = ("relu", "identity")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_lib = None


def bn_act_reference(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """The plain epilogue: scale and shift cast to x's dtype, one multiply,
    one add, then relu (zero gradient at zero, like jax.nn.relu)."""
    y = x * scale.to(x.dtype) + shift.to(x.dtype)
    if act == "relu":
        y = torch.relu(y)
    return y


def _kernel():
    global _lib
    if _lib is None:
        from deeplearning4j_tpu_torch.ops import _build

        lib = _build.load("bn_act")
        lib.bn_act_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.bn_act_launch.restype = ctypes.c_int
        lib.bn_act_error_string.argtypes = [ctypes.c_int]
        lib.bn_act_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"bn_act act must be one of {ACTS}, got {act!r}")
    if x.dim() < 1:
        raise ValueError("bn_act needs x with a trailing channel axis")
    c = x.shape[-1]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"bn_act {name} must have shape ({c},), got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"bn_act {name} is on {t.device}, x on "
                             f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(
            "bn_act needs x contiguous with channels last (NHWC); got "
            f"shape {tuple(x.shape)} strides {x.stride()}")


def _launch(x: torch.Tensor, scale: torch.Tensor,
            shift: torch.Tensor, act: str) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bn_act kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"bn_act kernel takes contiguous float32 {name},"
                            f" got {t.dtype}")
    lib = _kernel()
    y = torch.empty_like(x)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    if rows == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.bn_act_launch(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
        rows, c, _DTYPE_CODES[x.dtype], int(act == "relu"), x.device.index,
        stream)
    if err != 0:
        raise RuntimeError(
            f"bn_act kernel launch failed: "
            f"{lib.bn_act_error_string(err).decode()} (code {err})")
    with _count_lock:
        bn_act.launches += 1
    return y


def _forward(x, scale, shift, act):
    if x.is_cuda:
        return _launch(x, scale, shift, act)
    if x.device.type != "cpu":
        raise ValueError(f"bn_act runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    return bn_act_reference(x, scale, shift, act)


class _BnAct(torch.autograd.Function):
    """Forward through the kernel; backward recomputes through the plain
    epilogue (exact gradients, nothing saved beyond the inputs)."""

    @staticmethod
    def forward(ctx, x, scale, shift, act):
        ctx.save_for_backward(x, scale, shift)
        ctx.act = act
        return _forward(x, scale, shift, act)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y = bn_act_reference(*ins, ctx.act)
            got = iter(torch.autograd.grad(
                y, [t for t in ins if t.requires_grad], g))
        return (*(next(got) if n else None for n in need), None)


def bn_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           act: str = "relu") -> torch.Tensor:
    """y = act(x * scale + shift) over channels-last x ([..., c], contiguous),
    per-channel float32 scale/shift. CUDA tensors launch the kernel (which
    counts `bn_act.launches`); CPU tensors compute the plain version."""
    _check(x, scale, shift, act)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or shift.requires_grad):
        return _BnAct.apply(x, scale, shift, act)
    return _forward(x, scale, shift, act)


#: kernel launches in this process (CUDA tensors only)
bn_act.launches = 0
