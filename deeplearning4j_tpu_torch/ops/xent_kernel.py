"""Fused linear + softmax cross-entropy through the output layer's weights,
forward and backward, logits never written to device memory.

Replaces two TPU kernels of deeplearning4j_tpu/ops/xent_kernel.py: the
forward `_fwd_kernel` (its `pl.pallas_call` is in `_fwd`) and the backward
`_bwd_kernel` with its dz variants `_dz_dense` / `_dz_idx` (`pl.pallas_call`
in `_bwd`). `RnnOutput.compute_loss` reaches them through
`_fused_xent_per_example`: one launch of each per training step of the zoo
TransformerLM.

    per_row = T * logsumexp(z) - sum_v t_v * z_v,  z = x @ W + b,  T = sum t

The forward kernel streams the vocabulary through an online logsumexp and
also returns lse, T, the labels' argmax and a per-row one-hot flag. The
backward recomputes z per tile and returns the dz spill (bfloat16 under
the mixed-precision policy, as in the JAX package), dx = dz . W^T from the
spill, and db; it reads
no [n, v] labels when every row is one-hot, choosing on the device from the
flag (the JAX package's lax.cond), so the host never waits. dW = x^T . dz
stays a plain matrix product (`ops.linear.dot`), as the JAX package leaves
it to XLA. Labels get no gradient.

Both products run on the tensor cores (mma.sync, operands streamed by
cp.async): bfloat16 as bfloat16 products with float32 sums, float32 as
3xTF32 (each operand split into a TF32 part and the rest, three products
per step added into float32), so a float32 kernel computes float32
whatever the precision policy. At the trained shape (n = 8192 rows, d =
512, v = 8192) the float32 bound is 3 x 68.7 GFLOP over TF32's 495
TFLOP/s on an H100 SXM: forward 0.42 ms, backward (z and dx) 0.83 ms. z
reads W through a transposed copy made by the first launch of each call
(scratch of d v elements); the backward's z and dz and its dx = dz . W^T,
which reads the spill, are separate launches. Their design is described
in csrc/linear_xent.cu.

`linear_xent_fwd` and `linear_xent_bwd` launch the kernels for CUDA tensors
(counting `.launches`) and raise on anything they do not take; CPU tensors
compute `linear_xent_fwd_reference` / `linear_xent_bwd_reference`, the plain
versions the kernels are held against. The JAX package's block planner
(`plan`) and its `DL4J_TPU_PALLAS_XENT` gate are TPU VMEM and tiling
decisions and are not ported: the kernels take any n, d and v.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.ops import linear as ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 128  # rows per block tile (csrc/linear_xent.cu kBM)
_COLS = 128  # vocab columns per tile (kBN)

_count_lock = threading.Lock()
_lib = None


def _z(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """z = x . W + b in float32 (products of float32 operands, exact for
    bfloat16 ones, as the TPU kernel's preferred_element_type=float32)."""
    with dtypes.exact_float32_matmul():
        return torch.matmul(x.float(), w.float()) + b.float()


def linear_xent_reference(x, w, b, labels) -> torch.Tensor:
    """The JAX package's reference formulation: -sum t * log_softmax(z)
    per row, float32."""
    logp = torch.log_softmax(_z(x, w, b), dim=-1)
    return -(labels.float() * logp).sum(dim=-1)


def linear_xent_fwd_reference(x, w, b, labels):
    """The plain version of the forward kernel: (per_row, lse, T, idx,
    onehot), float32 except idx (int32, the first column holding the row's
    largest label)."""
    z = _z(x, w, b)
    t = labels.float()
    lse = torch.logsumexp(z, dim=-1)
    ts = t.sum(dim=-1)
    tz = (t * z).sum(dim=-1)
    t2 = (t * t).sum(dim=-1)
    bt, idx = t.max(dim=-1)
    one = (((ts - 1.0).abs() < 1e-4) & ((t2 - 1.0).abs() < 1e-4)
           & ((bt - 1.0).abs() < 1e-4))
    return ts * lse - tz, lse, ts, idx.to(torch.int32), one.float()


def linear_xent_bwd_reference(x, w, b, labels, lse, tsum, g):
    """The plain version of the backward kernel: (dx in x's dtype, the dz
    spill in x's dtype, db float32). dz = (softmax(z) * T - t) * g, the dense
    variant: for a batch whose rows are all one-hot, T is exactly 1 and t
    exactly onehot(idx), so it equals the index variant bit for bit."""
    p = torch.exp(_z(x, w, b) - lse[:, None])
    dz = (p * tsum[:, None] - labels.float()) * g.float()[:, None]
    with dtypes.exact_float32_matmul():
        dx = torch.matmul(dz, w.float().transpose(0, 1))
    return dx.to(x.dtype), dz.to(x.dtype), dz.sum(dim=0)


def _kernel():
    global _lib
    if _lib is None:
        from deeplearning4j_tpu_torch.ops import _build

        lib = _build.load("linear_xent")
        sizes = [ctypes.c_int64] * 3
        tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.linear_xent_fwd_launch.argtypes = [ctypes.c_void_p] * 12 + sizes \
            + [ctypes.c_int] + tail
        lib.linear_xent_bwd_launch.argtypes = [ctypes.c_void_p] * 14 + sizes \
            + [ctypes.c_int] + tail
        for fn in (lib.linear_xent_fwd_launch, lib.linear_xent_bwd_launch):
            fn.restype = ctypes.c_int
        lib.linear_xent_error_string.argtypes = [ctypes.c_int]
        lib.linear_xent_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, w, b, labels) -> None:
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 or labels.dim() != 2:
        raise ValueError(f"linear_xent takes x [n, d], W [d, v], b [v], "
                         f"labels [n, v]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}, "
                         f"{tuple(labels.shape)}")
    n, d = x.shape
    v = w.shape[1]
    if w.shape[0] != d or b.shape[0] != v or labels.shape != (n, v):
        raise ValueError(f"linear_xent shapes disagree: x {tuple(x.shape)}, "
                         f"W {tuple(w.shape)}, b {tuple(b.shape)}, labels "
                         f"{tuple(labels.shape)}")
    if d == 0 or v == 0:
        raise ValueError("linear_xent needs d > 0 and v > 0")
    for name, t in (("W", w), ("b", b), ("labels", labels)):
        if t.device != x.device:
            raise ValueError(f"linear_xent {name} is on {t.device}, x on "
                             f"{x.device}")
    if w.dtype != x.dtype:
        raise ValueError(f"linear_xent W is {w.dtype}, x {x.dtype}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"linear_xent runs on CUDA or CPU tensors, not "
                         f"{x.device}")


def _kernel_inputs(x, w, b, labels):
    """Checks what the kernels take; returns (b, labels) as the float32
    contiguous tensors they read (the TPU kernel widens both in-kernel)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"linear_xent kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t in (("x", x), ("W", w)):
        if not t.is_contiguous():
            raise ValueError(f"linear_xent needs {name} contiguous; got "
                             f"strides {t.stride()}")
    return (b.float().contiguous(), labels.float().contiguous())


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _raise(what: str, lib, err: int) -> None:
    raise RuntimeError(f"linear_xent {what} kernel launch failed: "
                       f"{lib.linear_xent_error_string(err).decode()} "
                       f"(code {err})")


def _splits(dev, n, v) -> int:
    """Vocabulary splits of the z kernels' tiles: one wave of blocks (one
    per SM: a z kernel's shared memory holds an SM) fills the card, and no
    split is empty."""
    row_blocks = -(-n // _ROWS)
    tiles = -(-v // _COLS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = max(1, min(tiles, sms // row_blocks))
    return -(-tiles // -(-tiles // nsplit))


def linear_xent_fwd(x, w, b, labels):
    """(per_row, lse, T, idx, onehot) of rows of x against W [d, v], b [v]
    and labels [n, v]: float32 [n] except idx (int32). x and W share a
    dtype (float32 or bfloat16 on CUDA). CUDA tensors launch the forward
    kernel (counting `linear_xent_fwd.launches`); CPU tensors compute the
    plain version."""
    _check(x, w, b, labels)
    if not x.is_cuda:
        return linear_xent_fwd_reference(x, w, b, labels)
    bf, lf = _kernel_inputs(x, w, b, labels)
    n, d = x.shape
    v = w.shape[1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    per_row, lse, ts, oh = (torch.empty(n, **f32) for _ in range(4))
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return per_row, lse, ts, idx, oh
    nsplit = _splits(dev, n, v)
    wt = torch.empty((v, d), dtype=x.dtype, device=dev)  # W^T, scratch
    part = torch.empty(6 * nsplit * n, **f32)
    part_idx = torch.empty(nsplit * n, dtype=torch.int32, device=dev)
    lib = _kernel()
    err = lib.linear_xent_fwd_launch(
        x.data_ptr(), w.data_ptr(), bf.data_ptr(), lf.data_ptr(),
        wt.data_ptr(), part.data_ptr(), part_idx.data_ptr(),
        per_row.data_ptr(), lse.data_ptr(), ts.data_ptr(), idx.data_ptr(),
        oh.data_ptr(), n, d, v, nsplit, _DTYPE_CODES[x.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise("forward", lib, err)
    _count(linear_xent_fwd)
    return per_row, lse, ts, idx, oh


def linear_xent_bwd(x, w, b, labels, idx, all_onehot, lse, tsum, g):
    """(dx, dz, db) for the per-row cotangent g (float32 [n]), from the
    forward's lse, T and idx and the device scalar `all_onehot` (1.0 when
    every row is one-hot: the kernel then reads idx and no labels). dx and
    the dz spill [n, v] are in x's dtype, db float32 [v]. CUDA tensors
    launch the backward kernels (z and dz, dx, the db sum; counted once in
    `linear_xent_bwd.launches`); CPU tensors compute the plain version."""
    _check(x, w, b, labels)
    n = x.shape[0]
    for name, r in (("lse", lse), ("T", tsum), ("g", g), ("idx", idx)):
        if r.shape != (n,) or r.device != x.device or not r.is_contiguous():
            raise ValueError(f"linear_xent backward needs {name} contiguous "
                             f"[{n}] on {x.device}, got {tuple(r.shape)} on "
                             f"{r.device}")
        if name != "idx" and r.dtype != torch.float32:
            raise ValueError(f"linear_xent backward needs {name} float32, "
                             f"got {r.dtype}")
    if idx.dtype != torch.int32 or all_onehot.numel() != 1 or \
            all_onehot.dtype != torch.float32 or \
            all_onehot.device != x.device:
        raise ValueError("linear_xent backward needs idx int32 and "
                         "all_onehot a float32 scalar on x's device")
    if not x.is_cuda:
        return linear_xent_bwd_reference(x, w, b, labels, lse, tsum, g)
    bf, lf = _kernel_inputs(x, w, b, labels)
    d, v = x.shape[1], w.shape[1]
    dev = x.device
    dx = torch.empty_like(x)
    dz = torch.empty((n, v), dtype=x.dtype, device=dev)
    db = torch.zeros(v, dtype=torch.float32, device=dev)
    if n == 0:
        return dx, dz, db
    wt = torch.empty((v, d), dtype=x.dtype, device=dev)  # W^T, scratch
    db_part = torch.empty(-(-n // _ROWS) * v, dtype=torch.float32,
                          device=dev)
    lib = _kernel()
    err = lib.linear_xent_bwd_launch(
        x.data_ptr(), w.data_ptr(), bf.data_ptr(), lf.data_ptr(),
        wt.data_ptr(), idx.data_ptr(), all_onehot.data_ptr(),
        lse.data_ptr(), tsum.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dz.data_ptr(), db_part.data_ptr(), db.data_ptr(), n, d, v,
        _splits(dev, n, v), _DTYPE_CODES[x.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise("backward", lib, err)
    _count(linear_xent_bwd)
    return dx, dz, db


class _LinearXent(torch.autograd.Function):
    """The JAX package's custom VJP: the forward kernel keeps lse, T, idx
    and the all-one-hot flag (a device scalar, never read on the host); the
    backward kernel gives dx, db and dz, and dW = x^T . dz is a plain
    product."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        per_row, lse, ts, idx, oh = linear_xent_fwd(x, w, b, labels)
        flag = (oh.amin() if oh.numel() else
                torch.ones((), device=oh.device)).reshape(())
        ctx.save_for_backward(x, w, b, labels, lse, ts, idx, flag)
        return per_row

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, lse, ts, idx, flag = ctx.saved_tensors
        dx, dz, db = linear_xent_bwd(x, w, b, labels, idx, flag, lse, ts,
                                     g.float().contiguous())
        dw = ops.dot(x.transpose(0, 1), dz).to(w.dtype)
        return dx, dw, db.to(b.dtype), None


def linear_xent_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """per_row [n] float32 of softmax cross-entropy of x [n, d] through the
    linear head W [d, v], b [v] against labels [n, v] (one-hot or soft),
    logits never materialized on the card. Gradients flow to x, W and b;
    labels are data."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _LinearXent.apply(x, w, b, labels)
    return linear_xent_fwd(x, w, b, labels)[0]


#: kernel launches in this process (CUDA tensors only)
linear_xent_fwd.launches = 0
linear_xent_bwd.launches = 0
