"""Fused LSTM over all timesteps, forward and backward, in two families.

Replaces four TPU kernels of deeplearning4j_tpu/ops/pallas_kernels.py:

  row 5  `_lstm_kernel` (pallas_call in `_lstm_fwd`; entry points
         `lstm_scan`, `lstm_scan_peephole`)             -> `lstm_scan`
  row 6  `_lstm_bwd_kernel` (pallas_call in `_lstm_bwd`) -> `lstm_scan_bwd`
  row 7  `_lstm_chunk_fwd_kernel` (pallas_call in `_lstm_chunked`; entry
         points `lstm_scan_chunked`, `lstm_scan_chunked_peephole`)
                                                        -> `lstm_scan_chunked`
  row 8  `_lstm_chunk_bwd_kernel` (pallas_call in `_lstm_chunked_bwd`)
                                                   -> `lstm_scan_chunked_bwd`

`LSTM` and `GravesLSTM` reach them through `_lstm_scan` in
nn/layers/recurrent.py for a sigmoid/tanh cell in float32 or bfloat16: the
chunked family (rows 7, 8) in the JAX package's long-sequence regime
(`chunked_lstm_auto_regime`), rows 5 and 6 everywhere else. Both families
give the same results; they differ in what the forward keeps for the
backward (hs, or float32 (h, c) checkpoints every CHUNK steps).

Contract, with the TPU kernels' numerics: zx [b, t, 4n] (x @ W + bias, gate
order i, f, g, o), R [n, 4n], optional Graves peepholes p [3, n] (pi, pf
see c_prev, po sees c_new), h0, c0 [b, n], all of one dtype (float32 or
bfloat16) and contiguous; an optional mask [b, t] of any numeric dtype
("live" = > 0; a masked step outputs zeros and carries h and c through).
R, p, z_t, h0 and c0 are raised to float32, h and c are carried in float32
and every product is formed to float32 accuracy (the plain versions with
TF32 off; the kernels as float32 FMAs or as 3xTF32 on the tensor cores);
hs, hT, cT and dzx come
back in zx's dtype, the checkpoints hck, cck [ceil(t / CHUNK), b, n] (the
carry entering each chunk, hck[0] = h0) and dR, dp, dh0, dc0 in float32.

The backward (row 6) recomputes the cell states from zx, R and the h carry
(hs itself when there is no mask, as the TPU kernel reads it; with a mask
hs is zero at masked steps, so the carry is rebuilt in float32), then runs
the reverse dh/dc recurrence; masked steps pass dh and dc straight through
with dz = 0; padded rows never enter dR or dp. Row 8 walks the chunks in
reverse, recomputing each chunk's carries from its checkpoint, and runs the
same reverse step. The mask gets no gradient.

The CUDA kernels (csrc/lstm_scan.cu: rows 5 and 7; csrc/lstm_scan_bwd.cu:
rows 6 and 8) run the serial steps in thread-block clusters, R split by
columns over the blocks, h (forward) and the dh partial sums (backward)
exchanged through distributed shared memory. The forward's cluster (8 or
16 blocks) and batch rows per cluster (1-16) follow a plan per shape
(`plan`); for n <= 256 its slice of R stays in registers and its product
is float32 FMAs on the CUDA cores, past that 3xTF32 on the tensor cores.
The backward runs every product on the tensor cores (3xTF32 for float32)
and keeps off the chain what is not serial: dR is one product per chunk
over the whole card, row 6 without a mask forms z for all steps as one
product, and row 8 recomputes chunk j - 1 while it reverses chunk j. At
the trained shape (b=64, t=64, n=256, float32) row 5 is bound by 2.15
GFLOP of recurrent products over 67 TFLOP/s (0.032 ms per launch on an
H100 SXM) and row 6 by 6.44 GFLOP as 3xTF32 over 495 TFLOP/s (0.039 ms);
neither bound counts the serial chain of t dependent steps.

Each wrapper launches its kernel for CUDA tensors (counting `.launches` on
`lstm_scan`, `lstm_scan_bwd`, `lstm_scan_chunked`, `lstm_scan_chunked_bwd`)
and raises on anything it does not take; it never falls back. For CPU
tensors it computes the plain version the kernel is held against
(`lstm_scan_reference`, `lstm_scan_backward_reference`,
`lstm_scan_chunked_reference`, `lstm_scan_chunked_backward_reference`).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch import dtypes

MAX_N = 1024  # the kernels' cap on n (csrc/lstm_scan*.cu kMaxN)
# Time steps per chunk of the chunked family (rows 7, 8): the forward
# checkpoints the float32 carry entering every CHUNK-th step, the backward
# recomputes one chunk at a time from it. 64 is what the JAX package's
# `pick_lstm_chunk` gives at its measured long point (b=8, n=256, float32);
# on the card it sizes the backward's workspace (two chunk slots of 24 * b
# * CHUNK * n bytes each: csrc/lstm_scan_bwd.cu), not a fast-memory budget.
# Any t is taken: the last chunk may be shorter.
CHUNK = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_libs = {}


# ------------------------------------------------------------ plain versions
def _peepholes(p: Optional[torch.Tensor], n: int, like: torch.Tensor):
    if p is None:
        z = like.new_zeros(n, dtype=torch.float32)
        return z, z, z
    pf = p.float()
    return pf[0], pf[1], pf[2]


def _gates(z, c_prev, c_new, pv, n):
    """Gate activations from pre-activations and cell states (the TPU
    backward's `gates`); c_new is computed when None."""
    pi, pf, po = pv
    zi, zf, zg, zo = z.split(n, dim=-1)
    i = torch.sigmoid(zi + pi * c_prev)
    f = torch.sigmoid(zf + pf * c_prev)
    g = torch.tanh(zg)
    if c_new is None:
        c_new = f * c_prev + i * g
    o = torch.sigmoid(zo + po * c_new)
    return i, f, g, o, c_new


def _forward_reference(zx, R, h0, c0, p, mask, tc):
    """Rows 5 and 7: hs, hT, cT in zx's dtype and, with tc, the float32
    carries entering steps 0, tc, 2 tc, ..."""
    b, t, n4 = zx.shape
    n = n4 // 4
    Rf = R.float()
    pf = None if p is None else p.float()
    live = None if mask is None else mask > 0
    h, c = h0.float(), c0.float()
    outs, hck, cck = [], [], []
    with dtypes.exact_float32_matmul():
        for s in range(t):
            if tc is not None and s % tc == 0:
                hck.append(h)
                cck.append(c)
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
    out = (hs.to(zx.dtype), h.to(zx.dtype), c.to(zx.dtype))
    if tc is None:
        return out
    ck = zx.new_zeros((0, b, n), dtype=torch.float32)
    return out + ((torch.stack(hck) if hck else ck),
                  (torch.stack(cck) if cck else ck))


def lstm_scan_reference(zx: torch.Tensor, R: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor, p: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None):
    """The plain version of row 5: one step at a time in float32 (products
    with TF32 off), hs / hT / cT rounded to zx's dtype at the end."""
    return _forward_reference(zx, R, h0, c0, p, mask, None)


def lstm_scan_chunked_reference(zx, R, h0, c0, p=None, mask=None,
                                tc: int = CHUNK):
    """The plain version of row 7: row 5's (hs, hT, cT) and the float32
    checkpoints hck, cck [ceil(t / tc), b, n] of the carry entering steps
    0, tc, 2 tc, ... (hck[0] = h0)."""
    return _forward_reference(zx, R, h0, c0, p, mask, tc)


def _reverse_span(zx, Rf, pv, live, s0, s1, h, c, hs, g_hs, dh, dc):
    """The TPU backward's two phases over steps [s0, s1), from the float32
    carry (h, c) entering s0 and the cotangents (dh, dc) of the carry
    leaving s1 - 1. Phase 1 recomputes z and the cell states, and the h
    carry: hs where it is given and there is no mask, else recomputed in
    float32. Phase 2 is the reverse recurrence. Returns (dz per step, the h
    carry entering each step, dp [3, n], dh, dc entering s0)."""
    n = Rf.shape[0]
    pi, pf, po = pv
    c_entry = c
    zs, hin, cs = [], [], []
    for s in range(s0, s1):
        hin.append(h)
        z = zx[:, s].float() + h @ Rf
        _, _, _, o, c_new = _gates(z, c, None, pv, n)
        if live is not None:
            m = live[:, s, None]
            h = torch.where(m, o * torch.tanh(c_new), h)
            c = torch.where(m, c_new, c)
        else:
            h = hs[:, s].float() if hs is not None else o * torch.tanh(c_new)
            c = c_new
        zs.append(z)
        cs.append(c)
    dzs = [None] * (s1 - s0)
    dp = torch.zeros((3, n), dtype=torch.float32, device=Rf.device)
    for s in range(s1 - 1, s0 - 1, -1):
        k = s - s0
        c_prev = cs[k - 1] if k else c_entry
        c_new = cs[k]
        gh = g_hs[:, s].float()
        if live is not None:
            m = live[:, s, None]
            dh_in = torch.where(m, gh + dh, torch.zeros_like(dh))
            dc_in = torch.where(m, dc, torch.zeros_like(dc))
        else:
            dh_in, dc_in = gh + dh, dc
        i, f, g, o, _ = _gates(zs[k], c_prev, c_new, pv, n)
        tcn = torch.tanh(c_new)
        dzo = dh_in * tcn * o * (1.0 - o)
        dcc = dh_in * o * (1.0 - tcn * tcn) + dc_in + po * dzo
        dzg = dcc * i * (1.0 - g * g)
        dzi = dcc * g * i * (1.0 - i)
        dzf = dcc * c_prev * f * (1.0 - f)
        dz = torch.cat([dzi, dzf, dzg, dzo], dim=-1)
        dzs[k] = dz
        dp += torch.stack([(dzi * c_prev).sum(0), (dzf * c_prev).sum(0),
                           (dzo * c_new).sum(0)])
        dh_prev = dz @ Rf.t()
        dc_prev = dcc * f + pi * dzi + pf * dzf
        if live is not None:
            dh_prev = dh_prev + torch.where(m, torch.zeros_like(dh), dh)
            dc_prev = dc_prev + torch.where(m, torch.zeros_like(dc), dc)
        dh, dc = dh_prev, dc_prev
    return dzs, hin, dp, dh, dc


def _backward_reference(zx, R, p, mask, g_hs, g_hT, g_cT, spans):
    """Runs `spans` [(s0, s1, h, c, hs)], last first, through
    `_reverse_span` and sums dR = sum_s h_prev^T dz_s and dp over them."""
    b, t, n4 = zx.shape
    n = n4 // 4
    Rf = R.float()
    pv = _peepholes(p, n, zx)
    live = None if mask is None else mask > 0
    dh, dc = g_hT.float(), g_cT.float()
    dzs, hin = [None] * t, [None] * t
    dp = torch.zeros((3, n), dtype=torch.float32, device=zx.device)
    with dtypes.exact_float32_matmul():
        for s0, s1, h, c, hs in spans:
            dz_span, h_span, dp_span, dh, dc = _reverse_span(
                zx, Rf, pv, live, s0, s1, h, c, hs, g_hs, dh, dc)
            dzs[s0:s1], hin[s0:s1] = dz_span, h_span
            dp += dp_span
        if t:
            dz = torch.stack(dzs, dim=1)  # [b, t, 4n]
            dR = torch.stack(hin, dim=1).reshape(b * t, n).t() @ \
                dz.reshape(b * t, n4)
        else:
            dz = zx.new_zeros((b, 0, n4), dtype=torch.float32)
            dR = Rf.new_zeros((n, n4))
    return dz.to(zx.dtype), dR, None if p is None else dp, dh, dc


def lstm_scan_backward_reference(zx, R, h0, c0, hs, g_hs, g_hT, g_cT,
                                 p=None, mask=None):
    """The plain version of row 6, step by step in float32 (products with
    TF32 off): (dzx in zx's dtype, dR [n, 4n], dp [3, n] or None, dh0,
    dc0 [b, n]), the last four float32."""
    t = zx.shape[1]
    return _backward_reference(zx, R, p, mask, g_hs, g_hT, g_cT,
                               [(0, t, h0.float(), c0.float(), hs)])


def lstm_scan_chunked_backward_reference(zx, R, hck, cck, g_hs, g_hT, g_cT,
                                         p=None, mask=None,
                                         tc: int = CHUNK):
    """The plain version of row 8: the chunks in reverse, each recomputed
    from its float32 checkpoint (the h carry in float32, never hs), with
    row 6's reverse step. Returns what `lstm_scan_backward_reference`
    returns."""
    t = zx.shape[1]
    spans = [(s0, min(t, s0 + tc), hck[j], cck[j], None)
             for j, s0 in reversed(list(enumerate(range(0, t, tc))))]
    return _backward_reference(zx, R, p, mask, g_hs, g_hT, g_cT, spans)


# ------------------------------------------------------------------ kernels
def _load(name: str, setup):
    lib = _libs.get(name)
    if lib is None:
        from deeplearning4j_tpu_torch.ops import _build

        lib = _build.load(name)
        setup(lib)
        _libs[name] = lib
    return lib


def _setup_fwd(lib):
    sizes = [ctypes.c_int64] * 3
    lib.lstm_scan_launch.argtypes = [ctypes.c_void_p] * 9 + sizes + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lstm_scan_chunked_launch.argtypes = [ctypes.c_void_p] * 11 + sizes \
        + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lstm_scan_resident.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.lstm_scan_plan.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.lstm_scan_plan_for.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.lstm_scan_plan_for.restype = None
    lib.lstm_scan_queries.argtypes = [ctypes.c_int]
    for fn in (lib.lstm_scan_launch, lib.lstm_scan_chunked_launch,
               lib.lstm_scan_resident, lib.lstm_scan_plan,
               lib.lstm_scan_queries):
        fn.restype = ctypes.c_int
    lib.lstm_scan_error_string.argtypes = [ctypes.c_int]
    lib.lstm_scan_error_string.restype = ctypes.c_char_p


def _setup_bwd(lib):
    sizes = [ctypes.c_int64] * 4
    lib.lstm_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 18 + sizes + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lstm_scan_bwd_launch.restype = ctypes.c_int
    lib.lstm_scan_bwd_workspace_floats.argtypes = sizes
    lib.lstm_scan_bwd_workspace_floats.restype = ctypes.c_int64
    lib.lstm_scan_bwd_resident.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.lstm_scan_bwd_resident.restype = ctypes.c_int
    lib.lstm_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.lstm_scan_bwd_error_string.restype = ctypes.c_char_p


def _fwd_lib():
    return _load("lstm_scan", _setup_fwd)


def _bwd_lib():
    return _load("lstm_scan_bwd", _setup_bwd)


def resident(n: int, device=None, backward: bool = False) -> bool:
    """Whether the forward (or, with backward=True, the backward) kernel
    keeps its slice of R on chip for all steps at hidden width n (the
    forward in registers, the backward in shared memory; else it reads R
    from L2 every step)."""
    dev = torch.device("cuda" if device is None else device)
    got = (_bwd_lib().lstm_scan_bwd_resident if backward
           else _fwd_lib().lstm_scan_resident)(n, dev.index or 0)
    if got < 0:
        raise RuntimeError(f"lstm_scan: CUDA error {-got} reading the "
                           f"device's shared-memory limit")
    return bool(got)


PLAN_KEYS = ("cluster", "rows", "tiles", "resident", "active", "units")


def plan(b: int, n: int, device=None, active=None) -> dict:
    """The forward kernel's launch plan for b rows of width n: blocks per
    cluster, batch rows per cluster, batch tiles (clusters), whether R's
    slices stay on chip, how many clusters of that size the card runs at
    once, and hidden units per block. `active` is how many clusters of 8
    and of 16 blocks the card runs at once, asked of the device (once per
    device) when None."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    lib = _fwd_lib()
    if active is None:
        dev = torch.device("cuda" if device is None else device)
        err = lib.lstm_scan_plan(b, n, dev.index or 0, out)
        if err != 0:
            raise RuntimeError(f"lstm_scan: CUDA error {err} asking the "
                               f"device's cluster occupancy")
    else:
        lib.lstm_scan_plan_for(b, n, active[0], active[1], out)
    return dict(zip(PLAN_KEYS, out))


def _check_like(name, x, shape, like, dtype=None):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"lstm_scan {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)} for zx {tuple(like.shape)}")
    want = like.dtype if dtype is None else dtype
    if x.device != like.device or x.dtype != want:
        raise ValueError(f"lstm_scan {name} is {x.dtype} on {x.device}, "
                         f"expected {want} on {like.device}")
    if not x.is_contiguous():
        raise ValueError(f"lstm_scan needs {name} contiguous; got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")


def _check_inputs(zx, R, p, mask) -> None:
    if zx.dim() != 3 or zx.shape[-1] % 4:
        raise ValueError(f"lstm_scan takes zx [b, t, 4n], got shape "
                         f"{tuple(zx.shape)}")
    b, t, n4 = zx.shape
    if zx.dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm_scan takes float32 or bfloat16, got "
                        f"{zx.dtype}")
    if zx.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lstm_scan runs on CUDA or CPU tensors, not "
                         f"{zx.device}")
    _check_like("zx", zx, zx.shape, zx)
    _check_like("R", R, (n4 // 4, n4), zx)
    if p is not None:
        _check_like("p", p, (3, n4 // 4), zx)
    if mask is not None and (tuple(mask.shape) != (b, t)
                             or mask.device != zx.device):
        raise ValueError(f"lstm_scan mask is {tuple(mask.shape)} on "
                         f"{mask.device}, expected {(b, t)} on {zx.device}")


def _check(zx, R, p, h0, c0, mask) -> None:
    _check_inputs(zx, R, p, mask)
    b, n = zx.shape[0], zx.shape[-1] // 4
    _check_like("h0", h0, (b, n), zx)
    _check_like("c0", c0, (b, n), zx)


def _check_grads(zx, g_hs, g_hT, g_cT) -> None:
    b, t, n4 = zx.shape
    _check_like("g_hs", g_hs, (b, t, n4 // 4), zx)
    _check_like("g_hT", g_hT, (b, n4 // 4), zx)
    _check_like("g_cT", g_cT, (b, n4 // 4), zx)


def _check_checkpoints(zx, hck, cck) -> None:
    b, t, n4 = zx.shape
    shape = (-(-t // CHUNK), b, n4 // 4)
    _check_like("hck", hck, shape, zx, torch.float32)
    _check_like("cck", cck, shape, zx, torch.float32)


def _cap(n: int) -> None:
    if n > MAX_N:
        raise ValueError(f"lstm_scan kernels take n <= {MAX_N} hidden "
                         f"units, got n={n}")


def _mask_arg(mask):
    return None if mask is None else mask.to(torch.float32).contiguous()


def _ptr(x):
    return None if x is None else x.data_ptr()


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _launch_fwd(zx, R, p, h0, c0, mask, checkpoints: bool):
    b, t, n4 = zx.shape
    n = n4 // 4
    _cap(n)
    lib = _fwd_lib()
    hs = torch.empty((b, t, n), dtype=zx.dtype, device=zx.device)
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    hck = cck = None
    if checkpoints:
        hck = torch.empty((-(-t // CHUNK), b, n), dtype=torch.float32,
                          device=zx.device)
        cck = torch.empty_like(hck)
    if b * t == 0:
        hT.copy_(h0)
        cT.copy_(c0)
        return (hs, hT, cT) + ((hck, cck) if checkpoints else ())
    m = _mask_arg(mask)
    stream = torch.cuda.current_stream(zx.device).cuda_stream
    head = (zx.data_ptr(), R.data_ptr(), _ptr(p), _ptr(m), h0.data_ptr(),
            c0.data_ptr(), hs.data_ptr(), hT.data_ptr(), cT.data_ptr())
    if checkpoints:
        err = lib.lstm_scan_chunked_launch(
            *head, hck.data_ptr(), cck.data_ptr(), b, t, n, CHUNK,
            _DTYPE_CODES[zx.dtype], zx.device.index, stream)
    else:
        err = lib.lstm_scan_launch(*head, b, t, n, _DTYPE_CODES[zx.dtype],
                                   zx.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_scan kernel launch failed: "
            f"{lib.lstm_scan_error_string(err).decode()} (code {err})")
    if checkpoints:
        _count(lstm_scan_chunked)
        return hs, hT, cT, hck, cck
    _count(lstm_scan)
    return hs, hT, cT


def _launch_bwd(zx, R, p, mask, h0, c0, hs, hck, cck, g_hs, g_hT, g_cT):
    """Rows 6 (hs given) and 8 (checkpoints given): one call, which issues
    its kernels on the current stream and, with more than one chunk, on two
    side streams that it joins back to the current stream before it
    returns (so the caching allocator sees every tensor used on the
    current stream)."""
    b, t, n4 = zx.shape
    n = n4 // 4
    _cap(n)
    lib = _bwd_lib()
    dev = zx.device
    dzx = torch.empty_like(zx)
    dh0 = torch.empty((b, n), dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    if b * t == 0:
        dR = torch.zeros((n, n4), dtype=torch.float32, device=dev)
        dh0.copy_(g_hT)
        dc0.copy_(g_cT)
        return dzx, dR, None if p is None else dR.new_zeros((3, n)), dh0, dc0
    # the kernels write every element of dR and dp
    dR = torch.empty((n, n4), dtype=torch.float32, device=dev)
    dp = torch.empty((3, n), dtype=torch.float32, device=dev)
    chunked = hck is not None
    tc = min(CHUNK, t) if chunked else t
    ws = torch.empty(lib.lstm_scan_bwd_workspace_floats(b, t, n, tc),
                     dtype=torch.float32, device=dev)
    m = _mask_arg(mask)
    err = lib.lstm_scan_bwd_launch(
        zx.data_ptr(), R.data_ptr(), _ptr(p), _ptr(m), _ptr(h0), _ptr(c0),
        _ptr(hs), _ptr(hck), _ptr(cck), g_hs.data_ptr(), g_hT.data_ptr(),
        g_cT.data_ptr(), dzx.data_ptr(), dR.data_ptr(), dp.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), ws.data_ptr(), b, t, n, tc,
        _DTYPE_CODES[zx.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_scan backward kernel launch failed: "
            f"{lib.lstm_scan_bwd_error_string(err).decode()} (code {err})")
    _count(lstm_scan_chunked_bwd if chunked else lstm_scan_bwd)
    return dzx, dR, None if p is None else dp, dh0, dc0


def _on_cpu(zx, what: str) -> bool:
    """True for CPU tensors (the plain version runs); False for CUDA
    tensors (the kernel launches)."""
    if zx.is_cuda:
        return False
    if zx.device.type != "cpu":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not "
                         f"{zx.device}")
    return True


def _forward(zx, R, p, h0, c0, mask):
    if _on_cpu(zx, "lstm_scan"):
        return lstm_scan_reference(zx, R, h0, c0, p, mask)
    return _launch_fwd(zx, R, p, h0, c0, mask, checkpoints=False)


def lstm_scan_chunked_forward(zx, R, h0, c0, p=None, mask=None):
    """Row 7 with its checkpoints: (hs, hT, cT, hck, cck), hck and cck
    float32 [ceil(t / CHUNK), b, n]. CUDA tensors launch the kernel
    (counting `lstm_scan_chunked.launches`); CPU tensors compute
    `lstm_scan_chunked_reference`. No autograd: see `lstm_scan_chunked`."""
    _check(zx, R, p, h0, c0, mask)
    if _on_cpu(zx, "lstm_scan_chunked"):
        return lstm_scan_chunked_reference(zx, R, h0, c0, p, mask)
    return _launch_fwd(zx, R, p, h0, c0, mask, checkpoints=True)


def lstm_scan_bwd(zx, R, h0, c0, hs, g_hs, g_hT, g_cT, p=None, mask=None):
    """Row 6, the fused backward of `lstm_scan`: (dzx in zx's dtype, dR
    [n, 4n], dp [3, n] or None, dh0, dc0 [b, n], all four float32) from the
    forward's inputs, its hs and the cotangents g_hs [b, t, n], g_hT, g_cT
    [b, n] (zx's dtype). CUDA tensors launch the kernel (counting
    `lstm_scan_bwd.launches`); CPU tensors compute
    `lstm_scan_backward_reference`."""
    _check(zx, R, p, h0, c0, mask)
    _check_like("hs", hs, (*zx.shape[:2], zx.shape[2] // 4), zx)
    _check_grads(zx, g_hs, g_hT, g_cT)
    if _on_cpu(zx, "lstm_scan_bwd"):
        return lstm_scan_backward_reference(zx, R, h0, c0, hs, g_hs, g_hT,
                                            g_cT, p, mask)
    return _launch_bwd(zx, R, p, mask, h0, c0, hs, None, None, g_hs, g_hT,
                       g_cT)


def lstm_scan_chunked_bwd(zx, R, hck, cck, g_hs, g_hT, g_cT, p=None,
                          mask=None):
    """Row 8, the backward of the chunked family, from the forward's
    checkpoints hck, cck: returns what `lstm_scan_bwd` returns. CUDA
    tensors launch the kernel (counting `lstm_scan_chunked_bwd.launches`);
    CPU tensors compute `lstm_scan_chunked_backward_reference`."""
    _check_inputs(zx, R, p, mask)
    _check_checkpoints(zx, hck, cck)
    _check_grads(zx, g_hs, g_hT, g_cT)
    if _on_cpu(zx, "lstm_scan_chunked_bwd"):
        return lstm_scan_chunked_backward_reference(
            zx, R, hck, cck, g_hs, g_hT, g_cT, p, mask)
    return _launch_bwd(zx, R, p, mask, None, None, None, hck, cck, g_hs,
                       g_hT, g_cT)


def _cast_grads(got, zx, R, p, h0, c0):
    """The TPU VJPs' casts: each cotangent in its input's dtype, none for
    the mask."""
    dzx, dR, dp, dh0, dc0 = got
    return (dzx.to(zx.dtype), dR.to(R.dtype),
            None if p is None else dp.to(p.dtype), dh0.to(h0.dtype),
            dc0.to(c0.dtype), None)


class _LstmScan(torch.autograd.Function):
    """Rows 5 and 6: the forward kernel, and the fused backward kernel from
    what `_lstm_vjp_fwd` saves (zx, R, p, h0, c0, hs, mask)."""

    @staticmethod
    def forward(ctx, zx, R, p, h0, c0, mask):
        hs, hT, cT = _forward(zx, R, p, h0, c0, mask)
        ctx.save_for_backward(zx, R, p, h0, c0, hs, mask)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, g_hs, g_hT, g_cT):
        zx, R, p, h0, c0, hs, mask = ctx.saved_tensors
        got = lstm_scan_bwd(zx, R, h0, c0, hs, g_hs.contiguous(),
                            g_hT.contiguous(), g_cT.contiguous(), p, mask)
        return _cast_grads(got, zx, R, p, h0, c0)


class _LstmScanChunked(torch.autograd.Function):
    """Rows 7 and 8: what `_lstm_chunked_vjp_fwd` saves, the checkpoints
    hck and cck instead of hs."""

    @staticmethod
    def forward(ctx, zx, R, p, h0, c0, mask):
        hs, hT, cT, hck, cck = lstm_scan_chunked_forward(zx, R, h0, c0, p,
                                                         mask)
        ctx.save_for_backward(zx, R, p, h0, c0, hck, cck, mask)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, g_hs, g_hT, g_cT):
        zx, R, p, h0, c0, hck, cck, mask = ctx.saved_tensors
        got = lstm_scan_chunked_bwd(zx, R, hck, cck, g_hs.contiguous(),
                                    g_hT.contiguous(), g_cT.contiguous(), p,
                                    mask)
        return _cast_grads(got, zx, R, p, h0, c0)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def _scan(zx, R, p, h0, c0, mask):
    _check(zx, R, p, h0, c0, mask)
    if _wants_grad(zx, R, p, h0, c0):
        return _LstmScan.apply(zx, R, p, h0, c0, mask)
    return _forward(zx, R, p, h0, c0, mask)


def _scan_chunked(zx, R, p, h0, c0, mask):
    _check(zx, R, p, h0, c0, mask)
    if _wants_grad(zx, R, p, h0, c0):
        return _LstmScanChunked.apply(zx, R, p, h0, c0, mask)
    return lstm_scan_chunked_forward(zx, R, h0, c0, p, mask)[:3]


def lstm_scan(zx: torch.Tensor, R: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """LSTM over all t steps of zx [b, t, 4n] (see the module docstring).
    Returns (hs [b, t, n], hT [b, n], cT [b, n]) in zx's dtype, with a
    gradient through `lstm_scan_bwd`. CUDA tensors launch the kernel (which
    counts `lstm_scan.launches`); CPU tensors compute the plain version."""
    return _scan(zx, R, None, h0, c0, mask)


def lstm_scan_peephole(zx: torch.Tensor, R: torch.Tensor, p: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
    """`lstm_scan` with Graves peepholes p [3, n] = (pi, pf, po); launches
    count in `lstm_scan.launches` too (one kernel serves both)."""
    return _scan(zx, R, p, h0, c0, mask)


def lstm_scan_chunked(zx: torch.Tensor, R: torch.Tensor, h0: torch.Tensor,
                      c0: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """The chunked family's `lstm_scan`: the same (hs, hT, cT), keeping
    float32 checkpoints for a gradient through `lstm_scan_chunked_bwd`.
    Launches count in `lstm_scan_chunked.launches`."""
    return _scan_chunked(zx, R, None, h0, c0, mask)


def lstm_scan_chunked_peephole(zx: torch.Tensor, R: torch.Tensor,
                               p: torch.Tensor, h0: torch.Tensor,
                               c0: torch.Tensor,
                               mask: Optional[torch.Tensor] = None):
    """`lstm_scan_chunked` with Graves peepholes; launches count in
    `lstm_scan_chunked.launches` too."""
    return _scan_chunked(zx, R, p, h0, c0, mask)


#: kernel launches in this process (CUDA tensors only), one per wrapper
lstm_scan.launches = 0
lstm_scan_bwd.launches = 0
lstm_scan_chunked.launches = 0
lstm_scan_chunked_bwd.launches = 0
