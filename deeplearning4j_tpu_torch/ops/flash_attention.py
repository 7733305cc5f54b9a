"""Flash-attention forward o = softmax(q * scale . k^T) . v over [b, h, t, d].

Replaces the TPU kernel `_flash_fwd_kernel` of
deeplearning4j_tpu/ops/pallas_kernels.py (its `pl.pallas_call` is in
`_flash_fwd`). Every `TransformerBlock` reaches it through
`MultiHeadAttention.apply` when no key-padding mask is given: 6 launches per
forward of the zoo TransformerLM at 6 layers.

The CUDA kernel (csrc/flash_attention.cu) keeps float32 arithmetic on the
CUDA cores, so at the served shape (b=16, h=8, t=512, d=64, causal) it is
bound by operations: 4.30 GFLOP per launch, 4 * d per causal (q, k) pair,
over 67 TFLOP/s, 0.064 ms on an H100 SXM, against 0.020 ms for its 67 MB of
float32 bytes. Its design (one block per 64-row query tile, K/V tiles
streamed through shared memory, online softmax in float32, causal early
stop, any t) is described in the source.

`flash_attention` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; it never copies and never falls back.
For tensors on the CPU it computes `flash_attention_reference`, the plain
version the kernel is held against. There is no backward yet: the TPU
kernel's is a pair of Pallas kernels (dq, dkv), owed by the training slice.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch import dtypes

HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_lib = None


def default_scale(d: int) -> float:
    return d ** -0.5


def scale_in(dtype: torch.dtype, scale: float) -> float:
    """`scale` rounded to `dtype`, as the TPU kernel's `q * scale` (a weakly
    typed Python scalar) and `ops.attention.sdpa` (`asarray(scale,
    q.dtype)`) both take it."""
    return float(torch.tensor(scale, dtype=dtype))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """The plain version: q scaled in its own dtype, float32 scores, masked,
    softmax over the whole row with P rounded to v's dtype before the
    product, o = (P . v) / l in q's dtype; lse = m + log(l) in float32."""
    d = q.shape[-1]
    s_q = scale_in(q.dtype, default_scale(d) if scale is None else scale)
    qs = q * torch.tensor(s_q, dtype=q.dtype, device=q.device)
    with dtypes.exact_float32_matmul():
        s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
        if causal:
            tq, tk = s.shape[-2], s.shape[-1]
            keep = torch.ones(tq, tk, dtype=torch.bool,
                              device=s.device).tril()
            s = s.masked_fill(~keep, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
        o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    o = o.to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def _kernel():
    global _lib
    if _lib is None:
        from deeplearning4j_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"flash_attention takes [b, h, t, d] tensors, got "
                         f"q of shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"flash_attention {name} has shape "
                             f"{tuple(t.shape)}, q {tuple(q.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention {name} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(
                f"flash_attention needs {name} contiguous [b, h, t, d]; got "
                f"shape {tuple(t.shape)} strides {t.stride()} (copy the "
                f"head-split view explicitly)")


def _launch(q, k, v, causal: bool, scale: float, return_lse: bool):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim in "
                         f"{HEAD_DIMS}, got {d}")
    lib = _kernel()
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b * h, t, d,
        scale_in(q.dtype, scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
        q.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{lib.flash_attention_error_string(err).decode()} (code {err})")
    if b * h * t > 0:
        with _count_lock:
            flash_attention.launches += 1
    return (o, lse) if return_lse else o


def _forward(q, k, v, causal, scale, return_lse):
    if q.is_cuda:
        return _launch(q, k, v, causal, scale, return_lse)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    return flash_attention_reference(q, k, v, causal, scale, return_lse)


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel. The backward is the TPU kernel's Pallas
    pair (`_flash_bwd_dq_kernel`, `_flash_bwd_dkv_kernel`), to be ported as
    kernels with the training slice; until then it raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, return_lse):
        return _forward(q, k, v, causal, scale, return_lse)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash_attention has no backward yet: the dq/dkv kernels (TPU "
            "kernel rows 3 and 4) come with the training slice, ROADMAP A4")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """softmax(q * scale . k^T) . v over contiguous [b, h, t, d] q, k, v of
    one shape and dtype (`scale` defaults to d ** -0.5). Returns o in q's
    dtype, and with `return_lse` also the float32 [b, h, t] logsumexp.
    CUDA tensors launch the kernel (which counts `flash_attention.launches`);
    CPU tensors compute the plain version."""
    _check(q, k, v)
    s = default_scale(q.shape[-1]) if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, s, return_lse)
    return _forward(q, k, v, causal, s, return_lse)


#: kernel launches in this process (CUDA tensors only)
flash_attention.launches = 0
