"""Fused LSTM forward over all timesteps: hs, hT, cT = scan(zx, R, h0, c0).

Replaces the TPU kernel `_lstm_kernel` of deeplearning4j_tpu/ops/
pallas_kernels.py (its `pl.pallas_call` is in `_lstm_fwd`; entry points
`lstm_scan` and `lstm_scan_peephole`, whose names and argument order these
keep). `LSTM` and `GravesLSTM` reach it through `_lstm_scan` in
nn/layers/recurrent.py for a sigmoid/tanh cell in float32 or bfloat16: two
launches per forward of the zoo TextGenerationLSTM, two per `rnn_time_step`
call.

Contract, with the TPU kernel's numerics: zx [b, t, 4n] (x @ W + bias, gate
order i, f, g, o), R [n, 4n], optional Graves peepholes p [3, n] (pi, pf
see c_prev, po sees c_new), h0, c0 [b, n], all of one dtype (float32 or
bfloat16) and contiguous; an optional mask [b, t] of any numeric dtype
("live" = > 0; a masked step outputs zeros and carries h and c through).
R, p, z_t, h0 and c0 are raised to float32, h and c are carried in float32
and `h @ R` is formed in float32; hs, hT and cT come back in zx's dtype.

The CUDA kernel (csrc/lstm_scan.cu) runs all t steps in one launch, with R
split by columns over a cluster of 8 blocks and h exchanged through
distributed shared memory. At the served shape (b=64, t=64, n=256,
peephole, float32) it is bound by operations: 2.15 GFLOP of recurrent
products over 67 TFLOP/s, 0.032 ms per launch on an H100 SXM, against
0.0067 ms for its 22.3 MB; the bound leaves out the serial chain of t
steps.

`lstm_scan` / `lstm_scan_peephole` launch the kernel for CUDA tensors and
raise on anything it does not take; they never fall back. For CPU tensors
they compute `lstm_scan_reference`, the plain version the kernel is held
against. There is no backward yet: the TPU kernel's is `_lstm_bwd`, owed by
the recurrent-training slice.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch import dtypes

MAX_N = 1024  # the kernel's cap on n (csrc/lstm_scan.cu kMaxN)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_lib = None


def lstm_scan_reference(zx: torch.Tensor, R: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor, p: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None):
    """The plain version: one step at a time in float32 (products with TF32
    off), hs / hT / cT rounded to zx's dtype at the end."""
    b, t, n4 = zx.shape
    n = n4 // 4
    Rf = R.float()
    pf = None if p is None else p.float()
    live = None if mask is None else mask > 0
    h, c = h0.float(), c0.float()
    outs = []
    with dtypes.exact_float32_matmul():
        for s in range(t):
            z = zx[:, s].float() + h @ Rf
            zi, zf, zg, zo = z.split(n, dim=-1)
            if pf is not None:
                zi = zi + pf[0] * c
                zf = zf + pf[1] * c
            c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            if pf is not None:
                zo = zo + pf[2] * c_new
            h_new = torch.sigmoid(zo) * torch.tanh(c_new)
            h_out = h_new
            if live is not None:
                m = live[:, s, None]
                h_out = torch.where(m, h_new, torch.zeros_like(h_new))
                h_new = torch.where(m, h_new, h)
                c_new = torch.where(m, c_new, c)
            outs.append(h_out)
            h, c = h_new, c_new
    hs = (torch.stack(outs, dim=1) if outs
          else zx.new_zeros((b, 0, n), dtype=torch.float32))
    return hs.to(zx.dtype), h.to(zx.dtype), c.to(zx.dtype)


def _kernel():
    global _lib
    if _lib is None:
        from deeplearning4j_tpu_torch.ops import _build

        lib = _build.load("lstm_scan")
        lib.lstm_scan_launch.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.lstm_scan_launch.restype = ctypes.c_int
        lib.lstm_scan_resident.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.lstm_scan_resident.restype = ctypes.c_int
        lib.lstm_scan_error_string.argtypes = [ctypes.c_int]
        lib.lstm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def resident(n: int, device=None) -> bool:
    """Whether the kernel keeps its slice of R in shared memory for all
    steps at hidden width n (else it reads R from L2 every step)."""
    dev = torch.device("cuda" if device is None else device)
    got = _kernel().lstm_scan_resident(n, dev.index or 0)
    if got < 0:
        raise RuntimeError(f"lstm_scan: CUDA error {-got} reading the "
                           f"device's shared-memory limit")
    return bool(got)


def _check(zx, R, p, h0, c0, mask) -> None:
    if zx.dim() != 3 or zx.shape[-1] % 4:
        raise ValueError(f"lstm_scan takes zx [b, t, 4n], got shape "
                         f"{tuple(zx.shape)}")
    b, t, n4 = zx.shape
    n = n4 // 4
    if zx.dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm_scan takes float32 or bfloat16, got "
                        f"{zx.dtype}")
    want = {"R": (n, n4), "h0": (b, n), "c0": (b, n)}
    named = {"R": R, "h0": h0, "c0": c0}
    if p is not None:
        want["p"], named["p"] = (3, n), p
    for name, x in named.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"lstm_scan {name} has shape {tuple(x.shape)}, "
                             f"expected {want[name]} for zx "
                             f"{tuple(zx.shape)}")
        if x.device != zx.device or x.dtype != zx.dtype:
            raise ValueError(f"lstm_scan {name} is {x.dtype} on {x.device}, "
                             f"zx {zx.dtype} on {zx.device}")
    for name, x in dict(zx=zx, **named).items():
        if not x.is_contiguous():
            raise ValueError(f"lstm_scan needs {name} contiguous; got shape "
                             f"{tuple(x.shape)} strides {x.stride()}")
    if mask is not None and (tuple(mask.shape) != (b, t)
                             or mask.device != zx.device):
        raise ValueError(f"lstm_scan mask is {tuple(mask.shape)} on "
                         f"{mask.device}, expected {(b, t)} on {zx.device}")


def _launch(zx, R, p, h0, c0, mask):
    b, t, n4 = zx.shape
    n = n4 // 4
    if n > MAX_N:
        raise ValueError(f"lstm_scan kernel takes n <= {MAX_N} hidden units, "
                         f"got n={n}")
    lib = _kernel()
    hs = torch.empty((b, t, n), dtype=zx.dtype, device=zx.device)
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    if t == 0:
        hT.copy_(h0)
        cT.copy_(c0)
        return hs, hT, cT
    m = None if mask is None else mask.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(zx.device).cuda_stream
    err = lib.lstm_scan_launch(
        zx.data_ptr(), R.data_ptr(), None if p is None else p.data_ptr(),
        None if m is None else m.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), cT.data_ptr(), b, t, n,
        _DTYPE_CODES[zx.dtype], zx.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_scan kernel launch failed: "
            f"{lib.lstm_scan_error_string(err).decode()} (code {err})")
    if b * t > 0:
        with _count_lock:
            lstm_scan.launches += 1
    return hs, hT, cT


def _forward(zx, R, p, h0, c0, mask):
    if zx.is_cuda:
        return _launch(zx, R, p, h0, c0, mask)
    if zx.device.type != "cpu":
        raise ValueError(f"lstm_scan runs on CUDA or CPU tensors, not "
                         f"{zx.device}")
    return lstm_scan_reference(zx, R, h0, c0, p, mask)


class _LstmScan(torch.autograd.Function):
    """Forward through the kernel. The backward is the TPU kernel's fused
    Pallas backward (`_lstm_bwd`), to be ported as a kernel with the
    recurrent-training slice; until then it raises."""

    @staticmethod
    def forward(ctx, zx, R, p, h0, c0, mask):
        return _forward(zx, R, p, h0, c0, mask)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "lstm_scan has no backward yet: the fused LSTM backward (TPU "
            "kernel row 6) comes with the recurrent-training slice, ROADMAP "
            "A5")


def _scan(zx, R, p, h0, c0, mask):
    _check(zx, R, p, h0, c0, mask)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (zx, R, p, h0, c0)):
        return _LstmScan.apply(zx, R, p, h0, c0, mask)
    return _forward(zx, R, p, h0, c0, mask)


def lstm_scan(zx: torch.Tensor, R: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """LSTM over all t steps of zx [b, t, 4n] (see the module docstring).
    Returns (hs [b, t, n], hT [b, n], cT [b, n]) in zx's dtype. CUDA tensors
    launch the kernel (which counts `lstm_scan.launches`); CPU tensors
    compute the plain version."""
    return _scan(zx, R, None, h0, c0, mask)


def lstm_scan_peephole(zx: torch.Tensor, R: torch.Tensor, p: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
    """`lstm_scan` with Graves peepholes p [3, n] = (pi, pf, po); launches
    count in `lstm_scan.launches` too (one kernel serves both)."""
    return _scan(zx, R, p, h0, c0, mask)


#: kernel launches in this process (CUDA tensors only), both entry points
lstm_scan.launches = 0
