"""Flash attention o = softmax(q * scale . k^T) . v over [b, h, t, d], forward
and backward.

Replaces three TPU kernels of deeplearning4j_tpu/ops/pallas_kernels.py: the
forward `_flash_fwd_kernel` (its `pl.pallas_call` is in `_flash_fwd`) and
the backward pair `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` (both
`pl.pallas_call`s are in `_flash_bwd`). Every `TransformerBlock` reaches the
forward through `MultiHeadAttention.apply` when no key-padding mask is
given, and a training step the backward pair: 6 launches of each per step
of the zoo TransformerLM at 6 layers.

At the trained shape (b=16, h=8, t=512, d=64, causal) on an H100 SXM: the
forward kernel (csrc/flash_attention.cu) and the backward kernels
(csrc/flash_attention_bwd.cu) run their products on the tensor cores,
bfloat16 directly and float32 as 3xTF32, through the tile helpers both
include (csrc/flash_tiles.cuh). In float32 the forward's 4.30 GFLOP, dq's
6.45 GFLOP and dk/dv's 8.61 GFLOP take three TF32 products each over 495
TFLOP/s (0.026, 0.039 and 0.052 ms); in bfloat16 the forward is bound by
its 34 MB (0.010 ms at 3.35 TB/s). Their designs are described in the
sources.

`flash_attention` launches the forward kernel for CUDA tensors and raises on
anything the kernel does not take; it never copies and never falls back.
For tensors on the CPU it computes `flash_attention_reference`, the plain
version the kernel is held against. When a gradient is wanted it keeps the
forward's lse, and the backward computes delta = rowsum(dO * O) in plain
PyTorch (the JAX package leaves it to XLA), then launches the dq kernel
(`flash_attention_bwd_dq`) and the dk/dv kernel (`flash_attention_bwd_dkv`);
on the CPU both take `flash_attention_bwd_reference`'s formulas.
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
_bwd_lib = None


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


def _bwd_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
               want: str):
    """The dq ("dq") or dk/dv ("dkv") formulas of the TPU backward kernels
    over whole rows: q widened to float32 and scaled in float32, P rebuilt
    as exp(q.k - lse) and zeroed where causal masking removes the key,
    dS = P * (dO.v^T - delta); dq = scale * dS.k, dk = dS^T.q (q
    pre-scaled), dv = P^T.dO; all float32, rounded once to the inputs'
    dtype."""
    s_f = torch.tensor(scale, dtype=torch.float32, device=q.device)
    with dtypes.exact_float32_matmul():
        qs = q.float() * s_f
        kf, vf, dof = k.float(), v.float(), do.float()
        p = torch.exp(torch.matmul(qs, kf.transpose(-1, -2))
                      - lse.float()[..., None])
        if causal:
            tq, tk = p.shape[-2], p.shape[-1]
            keep = torch.ones(tq, tk, dtype=torch.bool,
                              device=p.device).tril()
            p = p.masked_fill(~keep, 0.0)
        ds = p * (torch.matmul(dof, vf.transpose(-1, -2))
                  - delta.float()[..., None])
        if want == "dq":
            return (torch.matmul(ds, kf) * s_f).to(q.dtype)
        dk = torch.matmul(ds.transpose(-1, -2), qs)
        dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def _row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, [b, h, t]."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  scale: Optional[float] = None):
    """The plain version of the backward: delta from o and do, then the dq
    and dk/dv formulas of `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel`.
    lse is the forward's float32 [b, h, t] logsumexp. Returns (dq, dk, dv)
    in the inputs' dtype."""
    s = default_scale(q.shape[-1]) if scale is None else float(scale)
    delta = _row_delta(o, do)
    dq = _bwd_plain(q, k, v, do, lse, delta, causal, s, "dq")
    dk, dv = _bwd_plain(q, k, v, do, lse, delta, causal, s, "dkv")
    return dq, dk, dv


def _bwd_kernel():
    global _bwd_lib
    if _bwd_lib is None:
        from deeplearning4j_tpu_torch.ops import _build

        lib = _build.load("flash_attention_bwd")
        common = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                  ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]
        lib.flash_attention_bwd_dq_launch.argtypes = [ctypes.c_void_p] * 7 \
            + common
        lib.flash_attention_bwd_dkv_launch.argtypes = [ctypes.c_void_p] * 8 \
            + common
        for fn in (lib.flash_attention_bwd_dq_launch,
                   lib.flash_attention_bwd_dkv_launch):
            fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    b, h, t, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError(f"flash_attention backward needs dO contiguous "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    for name, r in (("lse", lse), ("delta", delta)):
        if r.shape != (b, h, t) or r.dtype != torch.float32 \
                or r.device != q.device or not r.is_contiguous():
            raise ValueError(f"flash_attention backward needs {name} "
                             f"contiguous float32 {(b, h, t)} on {q.device},"
                             f" got {tuple(r.shape)} {r.dtype} on "
                             f"{r.device}")


def _launch_bwd(which: str, q, k, v, do, lse, delta, causal, scale):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention backward kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward kernels take head dim "
                         f"in {HEAD_DIMS}, got {d}")
    lib = _bwd_kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (b * h, t, d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], q.device.index, stream)
    ptrs = [a.data_ptr() for a in (q, k, v, do, lse, delta)]
    if which == "dq":
        out = (torch.empty_like(q),)
        err = lib.flash_attention_bwd_dq_launch(*ptrs, out[0].data_ptr(),
                                                *tail)
        counter = flash_attention_bwd_dq
    else:
        out = (torch.empty_like(k), torch.empty_like(v))
        err = lib.flash_attention_bwd_dkv_launch(
            *ptrs, out[0].data_ptr(), out[1].data_ptr(), *tail)
        counter = flash_attention_bwd_dkv
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward {which} kernel launch failed: "
            f"{lib.flash_attention_bwd_error_string(err).decode()} "
            f"(code {err})")
    if b * h * t > 0:
        with _count_lock:
            counter.launches += 1
    return out


def _bwd_entry(which: str, q, k, v, do, lse, delta, causal, scale):
    _check_bwd(q, k, v, do, lse, delta)
    s = default_scale(q.shape[-1]) if scale is None else float(scale)
    if q.is_cuda:
        return _launch_bwd(which, q, k, v, do, lse, delta, causal, s)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    out = _bwd_plain(q, k, v, do, lse, delta, causal, s, which)
    return (out,) if which == "dq" else out


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dq of attention over contiguous [b, h, t, d] q, k, v, dO of one
    dtype, from the forward's float32 lse and delta = rowsum(dO * O), both
    [b, h, t]. CUDA tensors launch the dq kernel (which counts
    `flash_attention_bwd_dq.launches`); CPU tensors compute the plain
    formulas."""
    return _bwd_entry("dq", q, k, v, do, lse, delta, causal, scale)[0]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            scale: Optional[float] = None):
    """(dk, dv) from the same inputs as `flash_attention_bwd_dq`; CUDA
    tensors launch the dk/dv kernel (counting
    `flash_attention_bwd_dkv.launches`)."""
    return _bwd_entry("dkv", q, k, v, do, lse, delta, causal, scale)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv): delta = rowsum(dO * O) in plain PyTorch, then the dq
    and dk/dv kernels (or their plain formulas on the CPU)."""
    delta = _row_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward through the forward kernel, keeping lse for the backward;
    the backward through the dq and dk/dv kernels. lse, when returned, is
    not differentiable (the TPU kernel's custom VJP returns o only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, return_lse):
        o, lse = _forward(q, k, v, causal, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        if return_lse:
            ctx.mark_non_differentiable(lse)
            return o, lse
        return o

    @staticmethod
    def backward(ctx, do, *unused):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


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
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
