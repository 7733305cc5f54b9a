"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on a CUDA device, including the paths the served shapes do
not reach (bn_act: ragged row counts, channel counts that are not a
multiple of the vector width, unaligned views; flash_attention: ragged t,
t = 1, non-causal, every head dim, the lse output, unaligned views, the
same bits from two launches; lstm_scan: masks with a
fully masked row, ragged b and n, long t, n past the shared-memory resident
width, the cap on n), the attention layer's routing to the kernel,
`rnn_time_step` on the card against `output`; the training kernels
(flash-attention dq and dk/dv, the fused linear + softmax cross-entropy
forward and backward, including the backward's device-side choice of
path) and one `fit` step of a small TransformerLM against the CPU; the
recurrent-training kernels (the fused LSTM backward, the time-chunked
forward and backward: masks, ragged b, t and n, a ragged last chunk, t = 1,
n at the cap, the same bits from two calls), autograd through both LSTM
families on the card, and one BPTT and one tBPTT `fit` of a small
TextGenerationLSTM against the CPU; a Keras InceptionV3 file imported onto
the card against its CPU import; a DL4J zip and a checkpoint zip restored
onto the card by default (and refused where there is no card); dropout
draws on the card repeating from the network's seed, and a DropConnect
Output layer through the fused cross-entropy; ParallelWrapper at world
size 1 over NCCL against fit on the card; fit over a host iterator through
the prefetch thread, a step with frozen layers and evaluate on a network
on the card, each against the CPU.

Marked `cuda`; they skip where torch.cuda.is_available() is False. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bn_act, 1 ulp of the dtype at the magnitude of the
multiply-add's terms (the kernel matches the plain version's rounding, so
the error is 0 in practice); flash_attention, 1e-5 (float32) or 2e-2
(bfloat16) of the plain output's largest magnitude (sums in another order,
P rounded at another running max), lse 1e-5 of its largest magnitude;
lstm_scan, 1e-5 (float32) or 2e-2 (bfloat16) times max(1, max |plain|) on
hs, hT and cT (sums in another order; bfloat16 rounds float32 values that
differ in their last bits); rnn_time_step against output, 1e-5 absolute on
probabilities with TF32 off; the LSTM backward and chunked kernels, each
output against 1e-5 (float32 forward outputs) or 1e-4 (float32 backward
outputs: sums over b t terms in another order) of its plain version's
largest magnitude, bfloat16 outputs 2e-2 (forward) or 1e-2 (dzx).
"""
import os

import pytest
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import flat_items
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
from deeplearning4j_tpu_torch.ops.bn_act import bn_act, bn_act_reference
from deeplearning4j_tpu_torch.ops.flash_attention import (
    _bwd_plain,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
from deeplearning4j_tpu_torch.ops.lstm import (
    CHUNK,
    MAX_N,
    lstm_scan,
    lstm_scan_backward_reference,
    lstm_scan_bwd,
    lstm_scan_chunked,
    lstm_scan_chunked_backward_reference,
    lstm_scan_chunked_bwd,
    lstm_scan_chunked_forward,
    lstm_scan_chunked_peephole,
    lstm_scan_chunked_reference,
    lstm_scan_peephole,
    lstm_scan_reference,
)
from deeplearning4j_tpu_torch.ops.xent_kernel import (
    linear_xent_bwd,
    linear_xent_bwd_reference,
    linear_xent_fwd,
    linear_xent_fwd_reference,
    linear_xent_reference,
    linear_xent_rows,
)
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM, TransformerLM

ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _check(x, scale, shift, act):
    before = bn_act.launches
    y = bn_act(x, scale, shift, act)
    ref = bn_act_reference(x, scale, shift, act)
    torch.cuda.synchronize()
    assert bn_act.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape and y.is_cuda
    mag = (x.float() * scale).abs() + shift.abs()
    assert bool(((y.float() - ref.float()).abs() <= ULP[x.dtype] * mag
                 + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("shape", [(1, 7, 7, 512), (3, 5, 5, 64),
                                   (2, 3, 3, 12), (1, 1, 1, 3), (49, 2048),
                                   (5, 1000)])
def test_kernel_matches_plain_version(cuda, dtype, act, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    scale = torch.rand(c, generator=g, device=cuda) + 0.5
    shift = torch.randn(c, generator=g, device=cuda)
    _check(x, scale, shift, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_view_takes_the_scalar_path(cuda, dtype):
    """A contiguous view that starts one element into its storage is not
    16-byte aligned; the kernel must still be right."""
    c = 64
    base = torch.randn(1 + 9 * c, device=cuda).to(dtype)
    x = base[1:].view(9, c)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _check(x, torch.rand(c, device=cuda) + 0.5, torch.randn(c, device=cuda),
           "relu")


@pytest.mark.cuda
def test_nan_passes_through_relu(cuda):
    x = torch.tensor([[float("nan"), -1.0, 2.0, 0.0]], device=cuda)
    y = bn_act(x, torch.ones(4, device=cuda), torch.zeros(4, device=cuda),
               "relu")
    out = y.cpu()
    assert torch.isnan(out[0, 0]) and out[0, 1:].tolist() == [0.0, 2.0, 0.0]


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "f64_scale", "cpu_scale"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    x = torch.randn(4, 8, device=cuda)
    s = torch.ones(8, device=cuda)
    h = torch.zeros(8, device=cuda)
    if bad == "float64":
        x = x.double()
    elif bad == "f64_scale":
        s = s.double()
    else:
        s = s.cpu()
    with pytest.raises((TypeError, ValueError)):
        bn_act(x, s, h, "relu")


FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _flash_check(cuda, shape, causal, dtype, lse):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    _flash_compare(q, k, v, causal, lse)


def _flash_compare(q, k, v, causal, lse):
    shape, dtype = tuple(q.shape), q.dtype
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal, return_lse=lse)
    ref = flash_attention_reference(q, k, v, causal, return_lse=lse)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    o, o_ref = (got[0], ref[0]) if lse else (got, ref)
    assert o.dtype == dtype and o.shape == q.shape and o.is_cuda
    err = float((o.float() - o_ref.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(o_ref.float().abs().max())
    if lse:
        assert got[1].dtype == torch.float32 and got[1].shape == shape[:3]
        assert float((got[1] - ref[1]).abs().max()) <= 1e-5 * max(
            1.0, float(ref[1].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("shape,causal", [
    ((16, 8, 512, 64), True),      # TransformerLM serving
    ((16, 8, 512, 64), False),
    ((2, 3, 200, 64), True),       # ragged t
    ((2, 3, 1, 64), True),         # t = 1
    ((1, 2, 65, 16), False),
    ((2, 2, 130, 32), True),
    ((2, 2, 127, 128), True),
    ((1, 1, 64, 128), False),
])
def test_flash_kernel_matches_plain_version(cuda, shape, causal, dtype, lse):
    _flash_check(cuda, shape, causal, dtype, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_is_deterministic(cuda, causal, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(2, 4, 300, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    runs = [flash_attention(q, k, v, causal, return_lse=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, r in zip(("o", "lse"), *runs):
        assert torch.equal(a, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("shape,causal", [
    ((2, 3, 200, 64), True),
    ((1, 2, 65, 16), False),
    ((2, 2, 127, 128), True),
])
def test_flash_kernel_takes_unaligned_tensors(cuda, shape, causal, dtype,
                                              lse):
    """q, k and v as contiguous views one element into larger buffers start
    off 16 bytes: the kernel copies them by 4-byte cp.async (float32) or
    plain loads (bfloat16) and still matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 2)
    n = shape[0] * shape[1] * shape[2] * shape[3]
    q, k, v = (torch.randn(n + 1, generator=g, device=cuda).to(dtype)[1:]
               .view(shape) for _ in range(3))
    assert all(a.is_contiguous() and a.data_ptr() % 16 for a in (q, k, v))
    _flash_compare(q, k, v, causal, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "float64", "head_dim_48",
                                 "head_dim_256", "strided", "cpu_k"])
def test_flash_kernel_refuses_what_it_does_not_take(cuda, bad):
    shape = (1, 2, 16, 48 if bad == "head_dim_48" else
             256 if bad == "head_dim_256" else 64)
    q, k, v = (torch.randn(shape, device=cuda) for _ in range(3))
    if bad in ("float16", "float64"):
        q, k, v = (a.to(getattr(torch, bad)) for a in (q, k, v))
    elif bad == "strided":
        q = torch.randn(1, 16, 2, 64, device=cuda).transpose(1, 2)
    elif bad == "cpu_k":
        k = k.cpu()
    before = flash_attention.launches
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 13, 512])
def test_attention_layer_launches_the_kernel_unless_masked(cuda, t):
    layer = MultiHeadAttention(n_heads=4, causal=True)
    params = {k: v.to(cuda) for k, v in layer.init_params(
        torch.Generator().manual_seed(0), it.recurrent(64, t)).items()}
    x = torch.randn(2, t, 64, device=cuda)
    before = flash_attention.launches
    with torch.inference_mode():
        layer.apply(params, x, state={}, train=False)
        assert flash_attention.launches == before + 1
        mask = torch.ones(2, t, device=cuda)
        layer.apply(params, x, state={}, train=False, mask=mask)
    assert flash_attention.launches == before + 1


LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _lstm_inputs(cuda, b, t, n, dtype, peephole, masked, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * scale
                ).to(dtype)

    zx = rnd(b, t, 4 * n)
    R = rnd(n, 4 * n, scale=(2.0 / (5 * n)) ** 0.5)
    p = rnd(3, n, scale=0.3) if peephole else None
    h0, c0 = rnd(b, n, scale=0.5), rnd(b, n, scale=0.5)
    mask = None
    if masked:
        lengths = torch.randint(1, t + 1, (b,), generator=g, device=cuda)
        mask = (torch.arange(t, device=cuda)[None] < lengths[:, None]).float()
        mask[min(1, b - 1)] = 0.0
    return zx, R, p, h0, c0, mask


def _lstm_check(cuda, b, t, n, dtype, peephole, masked):
    zx, R, p, h0, c0, mask = _lstm_inputs(cuda, b, t, n, dtype, peephole,
                                          masked, seed=b + t + n)
    before = lstm_scan.launches
    got = (lstm_scan_peephole(zx, R, p, h0, c0, mask) if peephole
           else lstm_scan(zx, R, h0, c0, mask))
    ref = lstm_scan_reference(zx, R, h0, c0, p, mask)
    torch.cuda.synchronize()
    assert lstm_scan.launches == before + 1
    for name, a, r in zip(("hs", "hT", "cT"), got, ref):
        assert a.dtype == dtype and a.shape == r.shape and a.is_cuda, name
        err = float((a.float() - r.float()).abs().max())
        assert err <= LSTM_TOL[dtype] * max(1.0, float(r.float().abs()
                                                       .max())), (name, err)
    if masked:
        row = min(1, b - 1)
        assert not got[0][row].float().abs().any()
        assert torch.equal(got[1][row], h0[row])
        assert torch.equal(got[2][row], c0[row])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n,peephole,masked", [
    (64, 64, 256, True, False),    # TextGenerationLSTM serving
    (64, 1, 256, True, False),     # rnn_time_step
    (64, 64, 256, False, False),   # plain cell
    (8, 64, 256, True, True),      # ragged lengths, one row fully masked
    (3, 7, 12, True, True),        # ragged small
    (8, 1024, 256, False, False),  # long t
    (16, 64, 512, True, False),    # wide n: R read from L2 every step
    (9, 5, 1024, False, True),     # the cap on n
    (1, 3, 1, True, False),
])
def test_lstm_kernel_matches_plain_version(cuda, b, t, n, peephole, masked,
                                           dtype):
    _lstm_check(cuda, b, t, n, dtype, peephole, masked)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n,peephole,masked", [
    (200, 9, 256, True, False),    # 16-row tiles beyond one wave
    (64, 9, 256, True, True),      # 10-row tiles (the served batch)
    (24, 9, 256, True, True),      # 4-row tiles
    (3, 9, 256, False, False),     # one-row tiles: half the threads idle
    (40, 9, 128, True, True),      # clusters of 8 blocks, 3-row tiles
    (9, 9, 100, True, False),      # n not a multiple of 16, cluster of 8
    (5, 9, 300, True, True),       # R read from L2, n not a power of two
    (8, 9, 1000, False, False),    # R read from L2, n not a multiple of 16
])
def test_lstm_kernel_plans_match_plain_version(cuda, b, t, n, peephole,
                                               masked, dtype):
    """Each launch plan (blocks per cluster, rows per cluster, R in
    registers or read from L2) at its edges, through both entry points."""
    plan = lstm_ops.plan(b, n)
    assert plan["resident"] == (n <= 256)
    assert plan["cluster"] == (8 if n <= 128 else 16)
    assert plan["tiles"] == -(-b // plan["rows"])
    assert plan["cluster"] * plan["units"] >= n
    assert plan["rows"] <= 16
    _lstm_check(cuda, b, t, n, dtype, peephole, masked)
    zx, R, p, h0, c0, mask = _lstm_inputs(cuda, b, t, n, dtype, peephole,
                                          masked, seed=b + t + n)
    _close_to("fwd", ("hs", "hT", "cT", "hck", "cck"),
              lstm_scan_chunked_forward(zx, R, h0, c0, p, mask),
              lstm_scan_chunked_reference(zx, R, h0, c0, p, mask))


@pytest.mark.cuda
def test_lstm_plan_rule_from_stated_occupancy(cuda):
    """The plan from stated counts of co-resident clusters: the fewest rows
    per cluster (at most 16) with which every batch tile runs at once,
    more than one wave only past 16 rows; clusters of 8 blocks up to
    n = 128, of 16 past it; R from L2 past n = 256, always in 8-row
    tiles."""
    def plan(b, n, a8, a16):
        return lstm_ops.plan(b, n, active=(a8, a16))

    assert plan(64, 256, 15, 7) == dict(cluster=16, rows=10, tiles=7,
                                        resident=1, active=7, units=16)
    assert plan(64, 256, 15, 8)["rows"] == 8
    assert plan(8, 256, 15, 7)["rows"] == 2
    assert plan(3, 256, 15, 7) == dict(cluster=16, rows=1, tiles=3,
                                       resident=1, active=7, units=16)
    assert plan(112, 256, 15, 7)["rows"] == 16
    assert plan(113, 256, 15, 7)["tiles"] == 8    # a second wave
    assert plan(200, 256, 15, 7)["tiles"] == 13
    assert plan(64, 128, 15, 7) == dict(cluster=8, rows=5, tiles=13,
                                        resident=1, active=15, units=16)
    assert plan(8, 257, 15, 7) == dict(cluster=16, rows=8, tiles=1,
                                       resident=0, active=7, units=32)
    assert plan(64, 1024, 15, 7)["rows"] == 8
    assert plan(1, 1000, 15, 7)["units"] == 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n,masked", [
    (64, 64, 256, False),    # row 5's served shape: 10-row tiles
    (8, 200, 256, True),     # row 7's: 2-row tiles, a ragged last chunk
    (9, 70, 64, True),       # clusters of 8 blocks
    (16, 20, 512, False),    # R read from L2
])
def test_lstm_forward_kernels_are_deterministic(cuda, b, t, n, masked,
                                                dtype):
    """Rows 5 and 7 give the same bits over two calls, in copies made on the
    current stream right after each call with no synchronize (every sum
    has a fixed order: the K shares' partials are added in order, no
    atomics), and the chunked and full entry points give the same hs, hT
    and cT bit for bit."""
    zx, R, p, h0, c0, mask = _lstm_inputs(cuda, b, t, n, dtype, True,
                                          masked, seed=t + n)
    runs = []
    for _ in range(2):
        full = lstm_scan_peephole(zx, R, p, h0, c0, mask)
        full_copy = [x.clone() for x in full]
        chunked = lstm_scan_chunked_forward(zx, R, h0, c0, p, mask)
        chunked_copy = [x.clone() for x in chunked]
        runs.append((full_copy, chunked_copy))
    torch.cuda.synchronize()
    (f1, c1), (f2, c2) = runs
    for a, r in zip(f1 + c1, f2 + c2):
        assert torch.equal(a, r)
    for a, r in zip(f1, c1[:3]):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_lstm_forward_asks_the_device_once(cuda):
    """The forward sets its kernels' attributes (shared memory, clusters of
    16) once per kernel and device, and asks the card's cluster occupancy
    once per device: launches at other shapes, dtypes and plans, and plan
    queries, ask nothing more once each kernel has run."""
    lib = lstm_ops._fwd_lib()
    shapes = [(64, 256), (8, 256), (8, 64), (8, 512)]

    def launch_all():
        for b, n in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                zx, R, p, h0, c0, _ = _lstm_inputs(cuda, b, 3, n, dtype,
                                                   True, False)
                lstm_scan_peephole(zx, R, p, h0, c0)
                lstm_scan_chunked_forward(zx, R, h0, c0, p)
            lstm_ops.plan(b, n)

    launch_all()
    torch.cuda.synchronize()
    asked = (lib.lstm_scan_queries(0), lib.lstm_scan_queries(1))
    assert asked[1] == 2  # clusters of 8 and of 16, once per device
    # 4 kernels at most (2 dtypes x R resident or from L2), two attributes
    # each
    assert 0 < asked[0] <= 8 and asked[0] % 2 == 0
    launch_all()
    torch.cuda.synchronize()
    assert (lib.lstm_scan_queries(0), lib.lstm_scan_queries(1)) == asked


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["noncontig", "float16", "n_over_cap",
                                 "cpu_R", "shape"])
def test_lstm_kernel_refuses_what_it_does_not_take(cuda, bad):
    n = MAX_N + 4 if bad == "n_over_cap" else 8
    zx, R, p, h0, c0, _ = _lstm_inputs(cuda, 2, 3, n, torch.float32, True,
                                       False)
    if bad == "noncontig":
        zx = zx.transpose(0, 1).contiguous().transpose(0, 1)
        assert not zx.is_contiguous()
    elif bad == "float16":
        zx, R, p, h0, c0 = (a.half() for a in (zx, R, p, h0, c0))
    elif bad == "cpu_R":
        R = R.cpu()
    elif bad == "shape":
        c0 = c0[:, :4].contiguous()
    before = lstm_scan.launches
    with pytest.raises((TypeError, ValueError),
                       match="1024" if bad == "n_over_cap" else None):
        lstm_scan_peephole(zx, R, p, h0, c0)
    assert lstm_scan.launches == before


@pytest.mark.cuda
def test_rnn_time_step_on_the_card_equals_output(cuda):
    net = TextGenerationLSTM(num_classes=77, max_length=64, seed=7).init()
    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(0, 77, (8, 16), generator=g, device=cuda)
    x = torch.nn.functional.one_hot(ids, 77).float()
    with dtypes.full_precision():
        full = net.output(x)
        before = lstm_scan.launches
        net.rnn_clear_previous_state()
        steps = torch.stack([net.rnn_time_step(x[:, s]) for s in range(16)],
                            dim=1)
        assert lstm_scan.launches == before + 2 * 16
        net.rnn_clear_previous_state()
        chunks = torch.cat([net.rnn_time_step(x[:, a:a + 4])
                            for a in range(0, 16, 4)], dim=1)
    assert steps.is_cuda and steps.shape == full.shape
    assert float((steps - full).abs().max()) <= 1e-5
    assert float((chunks - full).abs().max()) <= 1e-5


# ------------------------------------------------ flash-attention backward
# dq, dk, dv against the plain formulas on the same inputs, each within its
# tolerance times its own plain output's largest magnitude: float32 1e-4
# (sums over up to t keys or queries in another order), bfloat16 1e-2 (one
# rounding of the float32 result to bfloat16 apart). The magnitude is 1
# where the plain output is zero: all of it, or in exact arithmetic at t = 1,
# where one key gives P = 1 and O = V, so dS = dP - delta = 0 and the plain
# dq and dk are rounding noise. NaN fails.
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _close(got, want, tol, zero=False):
    """(within tol x max|want|, max abs error); the magnitude is 1 where
    `want` is all zero or `zero` (zero in exact arithmetic)."""
    err = float((got.float() - want.float()).abs().max())
    mag = 1.0 if zero else float(want.float().abs().max()) or 1.0
    return err <= tol * mag, err


def _flash_bwd_inputs(cuda, shape, causal, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    return q, k, v, do, o, lse, (do.float() * o.float()).sum(-1)


def _flash_bwd_check(cuda, shape, causal, dtype):
    q, k, v, do, o, lse, delta = _flash_bwd_inputs(cuda, shape, causal, dtype,
                                                   sum(shape) + 1)
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    ref = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                  before[1] + 1)
    tol, t = FLASH_BWD_TOL[dtype], shape[2]
    for name, got, want in zip("qkv", (dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == q.shape and got.is_cuda
        ok, err = _close(got, want, tol, t == 1 and name != "v")
        assert ok, (name, err)
    # the comparison sees a broken backward: a dS without its -delta term,
    # a zeroed dv, and (where they are not zero) a zeroed dq or dk
    scale = shape[-1] ** -0.5
    no_delta = torch.zeros_like(delta)
    broken = [(0, _bwd_plain(q, k, v, do, lse, no_delta, causal, scale,
                             "dq")),
              (1, _bwd_plain(q, k, v, do, lse, no_delta, causal, scale,
                             "dkv")[0]),
              (2, torch.zeros_like(dv))]
    if t > 1:
        broken += [(0, torch.zeros_like(dq)), (1, torch.zeros_like(dk))]
    for i, a in broken:
        assert not _close(a, ref[i], tol, t == 1 and i < 2)[0], i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", [
    ((16, 8, 512, 64), True),      # TransformerLM training
    ((2, 8, 512, 64), False),
    ((2, 3, 200, 64), True),       # ragged t
    ((2, 3, 1, 64), True),         # t = 1
    ((1, 2, 65, 16), False),
    ((2, 2, 130, 32), True),
    ((2, 2, 127, 128), True),
    ((1, 1, 64, 128), False),
])
def test_flash_bwd_kernels_match_plain_version(cuda, shape, causal, dtype):
    _flash_bwd_check(cuda, shape, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_are_deterministic(cuda, causal, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v, do, _, lse, delta = _flash_bwd_inputs(cuda, (2, 4, 300, 64),
                                                   causal, dtype, seed=9)
    runs = [(flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, r), name


@pytest.mark.cuda
def test_flash_autograd_on_the_card_launches_both_backward_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 4, 96, 32, generator=g, device=cuda)
               .requires_grad_() for _ in range(3))
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    flash_attention(q, k, v, True).square().sum().backward()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                  before[1] + 1)
    qc, kc, vc = (a.detach().cpu().requires_grad_() for a in (q, k, v))
    flash_attention_reference(qc, kc, vc, True).square().sum().backward()
    for got, want in ((q.grad, qc.grad), (k.grad, kc.grad),
                      (v.grad, vc.grad)):
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


# --------------------------------------------------------- linear xent
# each output within its tolerance times the plain output's largest
# magnitude (1 where that output is all zero): forward outputs (float32
# even for bfloat16 x and W: the products are exact in float32) 1e-4 (sums
# over d and over the vocabulary in another order); idx and the one-hot
# flag exact; backward dx and dz 1e-4 (float32) or 1e-2 (bfloat16, one
# rounding apart), db 1e-4
XENT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _xent_inputs(cuda, n, d, v, dtype, labels, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=cuda).to(dtype)
    w = (torch.randn(d, v, generator=g, device=cuda) * d ** -0.5).to(dtype)
    b = torch.randn(v, generator=g, device=cuda) * 0.1
    ids = torch.randint(0, v, (n,), generator=g, device=cuda)
    t = torch.nn.functional.one_hot(ids, v).float()
    if labels == "soft":
        t = torch.rand(n, v, generator=g, device=cuda) * 0.01
    elif labels == "mixed":
        r = min(3, n - 1)
        t[r] = 0.9 * t[r] + 0.1 / v     # one smoothed row
    return x, w, b, t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels", ["onehot", "soft", "mixed"])
@pytest.mark.parametrize("n,d,v", [(512, 128, 2048), (100, 70, 333),
                                   (64, 512, 8192), (1, 16, 5),
                                   # the 128 x 128 tiles' edges: n past one
                                   # row tile, rows not 16-byte aligned
                                   # (d = 70, v = 77), v just past one tile
                                   (129, 70, 77), (129, 64, 129),
                                   (257, 136, 129)])
def test_xent_kernels_match_plain_version(cuda, n, d, v, dtype, labels):
    x, w, b, t = _xent_inputs(cuda, n, d, v, dtype, labels, seed=n + v)
    before = (linear_xent_fwd.launches, linear_xent_bwd.launches)
    got = linear_xent_fwd(x, w, b, t)
    ref = linear_xent_fwd_reference(x, w, b, t)
    for name, a, r in zip(("per_row", "lse", "T"), got[:3], ref[:3]):
        ok, err = _close(a, r, 1e-4)
        assert ok and a.dtype == torch.float32, (name, err)
    assert torch.equal(got[3], ref[3]) and torch.equal(got[4], ref[4])
    assert float(got[4].min()) == (1.0 if labels == "onehot" else 0.0)
    g = torch.rand(n, generator=torch.Generator(device=cuda).manual_seed(1),
                   device=cuda)
    flag = got[4].amin().reshape(())
    dx, dz, db = linear_xent_bwd(x, w, b, t, got[3], flag, got[1], got[2], g)
    rdx, rdz, rdb = linear_xent_bwd_reference(x, w, b, t, got[1], got[2], g)
    torch.cuda.synchronize()
    assert (linear_xent_fwd.launches, linear_xent_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert dx.dtype == dz.dtype == dtype and db.dtype == torch.float32
    for name, a, r, tol in (("dx", dx, rdx, XENT_TOL[dtype]),
                            ("dz", dz, rdz, XENT_TOL[dtype]),
                            ("db", db, rdb, 1e-4)):
        ok, err = _close(a, r, tol)
        assert ok and a.shape == r.shape, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels", ["onehot", "mixed"])
def test_xent_kernels_are_deterministic(cuda, dtype, labels):
    """No atomics: two calls on the same inputs give the same bits."""
    x, w, b, t = _xent_inputs(cuda, 300, 96, 1000, dtype, labels, seed=9)
    g = torch.rand(300, generator=torch.Generator(device=cuda).manual_seed(2),
                   device=cuda)
    runs = []
    for _ in range(2):
        per_row, lse, ts, idx, oh = linear_xent_fwd(x, w, b, t)
        dx, dz, db = linear_xent_bwd(x, w, b, t, idx, oh.amin().reshape(()),
                                     lse, ts, g)
        runs.append((per_row, lse, dx, dz, db))
    torch.cuda.synchronize()
    for name, a, r in zip(("per_row", "lse", "dx", "dz", "db"), *runs):
        assert torch.equal(a, r), name


@pytest.mark.cuda
def test_xent_backward_branches_on_the_device_flag(cuda):
    """With the flag at 1 the kernel rebuilds one-hot rows from idx and
    reads no labels: zeroed labels change nothing. At 0 it reads them."""
    x, w, b, t = _xent_inputs(cuda, 256, 64, 1000, torch.float32, "onehot")
    per_row, lse, ts, idx, oh = linear_xent_fwd(x, w, b, t)
    g = torch.ones(256, device=cuda)
    want = linear_xent_bwd_reference(x, w, b, t, lse, ts, g)
    junk = torch.zeros_like(t)
    one = torch.ones((), device=cuda)
    dx, dz, db = linear_xent_bwd(x, w, b, junk, idx, one, lse, ts, g)
    assert _close(dz, want[1], 1e-4)[0] and _close(dx, want[0], 1e-4)[0]
    dx0, dz0, _ = linear_xent_bwd(x, w, b, junk, idx, one * 0, lse, ts, g)
    assert not _close(dz0, want[1], 1e-4)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_xent_rows_autograd_on_the_card(cuda, dtype):
    x, w, b, t = _xent_inputs(cuda, 300, 96, 777, dtype, "mixed", seed=5)
    wt = torch.linspace(0, 1, 300, device=cuda)
    leaves = [a.clone().requires_grad_() for a in (x, w, b)]
    before = (linear_xent_fwd.launches, linear_xent_bwd.launches)
    with dtypes.full_precision():  # dW = x^T . dz without TF32
        (linear_xent_rows(*leaves, t) * wt).sum().backward()
    assert (linear_xent_fwd.launches, linear_xent_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    cpu = [a.detach().cpu().float().requires_grad_() for a in (x, w, b)]
    (linear_xent_reference(*cpu, t.cpu()) * wt.cpu()).sum().backward()
    for a, r in zip(leaves, cpu):
        assert a.grad.dtype == a.dtype
        ok, err = _close(a.grad.cpu(), r.grad, XENT_TOL[dtype])
        assert ok, err


# ------------------------------------------------------------ training
@pytest.mark.cuda
def test_one_fit_step_on_the_card_matches_the_cpu(cuda):
    """One Adam step of a small TransformerLM (TF32 off) on the card and on
    the CPU from the same seed: scores within 1e-5 relative, the Adam m
    slots within 1e-4 of each leaf's largest magnitude, each param's
    change from its start within 1e-5 (the step moves an element by up to
    lr = 3e-4). An element whose CPU RMS gradient is below 1e-6 of the
    network's largest has a true gradient of zero (the key bias, to which
    softmax is invariant): Adam moves it on rounding noise alone, so it is
    held only to Adam's bound of lr. The step launches each kernel of the
    path."""
    cfg = dict(num_classes=512, max_length=64, d_model=64, n_heads=4,
               n_layers=2)
    g = torch.Generator().manual_seed(11)
    ids = torch.randint(0, 512, (4, 65), generator=g)
    x = ids[:, :64].to(torch.int32)
    y = torch.nn.functional.one_hot(ids[:, 1:], 512).float()
    card = TransformerLM(**cfg, seed=3).init()
    cpu = TransformerLM(**cfg, seed=3).init(device="cpu")
    counters = (flash_attention, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, linear_xent_fwd, linear_xent_bwd)
    before = [c.launches for c in counters]
    start = {k: v.copy() for k, v in cpu.get_param_table().items()}
    with dtypes.full_precision():
        card.fit(DataSet(x.to(cuda), y.to(cuda)))
        cpu.fit(DataSet(x, y))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2,
                                                                  1, 1]
    assert abs(card.score_ - cpu.score_) <= 1e-5 * abs(cpu.score_)
    tc, tp = card.get_param_table(), cpu.get_param_table()
    rms = {f"layer_{i}/{path}": v.sqrt().numpy()
           for i, b in enumerate(cpu.opt_state) if b
           for path, v in flat_items(b["v"])}
    floor = 1e-6 * max(float(r.max()) for r in rms.values())
    for k in tp:
        zero = rms[k] <= floor
        got, want = tc[k] - start[k], tp[k] - start[k]
        assert float(abs(got - want)[~zero].max(initial=0)) <= 1e-5, k
        assert float(abs(got)[zero].max(initial=0)) <= 1.01 * 3e-4, k
    for a, b in zip(card.opt_state, cpu.opt_state):
        if not a:
            continue
        assert int(a["t"]) == int(b["t"]) == 1
        for path, leaf in flat_items(b["m"]):
            got = dict(flat_items(a["m"]))[path].cpu()
            assert float((got - leaf).abs().max()) <= 1e-4 * max(
                float(leaf.abs().max()), 1e-30)


# ------------------------------------------------------ recurrent training
LSTM_BWD_TOL = {("fwd", torch.float32): 1e-5, ("fwd", torch.bfloat16): 2e-2,
                ("bwd", torch.float32): 1e-4, ("bwd", torch.bfloat16): 1e-2}


def _close_to(kind, names, got, ref):
    for name, a, r in zip(names, got, ref):
        if r is None:
            assert a is None, name
            continue
        assert a.dtype == r.dtype and a.shape == r.shape and a.is_cuda, name
        err = float((a.float() - r.float()).abs().max()) if a.numel() else 0.
        mag = (float(r.float().abs().max()) if r.numel() else 0.) or 1.0
        assert err <= LSTM_BWD_TOL[(kind, r.dtype)] * mag, (name, err, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n,peephole,masked", [
    (64, 64, 256, True, False),    # BPTT step of the TextGenerationLSTM
    (32, 50, 256, True, False),    # a tBPTT window
    (64, 64, 256, False, False),   # plain cell
    (8, 64, 256, True, True),      # ragged lengths, one row fully masked
    (3, 7, 12, True, True),        # ragged small
    (8, 1, 256, True, False),      # t = 1
    (9, 2 * CHUNK + 5, 256, True, True),  # a ragged last chunk, 2 tiles
    (16, 64, 512, True, False),    # wide n: R read from L2 every step
    (9, 5, 1024, False, True),     # the cap on n
    (1, 3, 1, True, False),
])
def test_lstm_backward_and_chunked_kernels_match_plain_versions(
        cuda, b, t, n, peephole, masked, dtype):
    """Rows 6, 7 and 8 from the same inputs: the chunked forward's outputs
    and checkpoints, the fused backward from its hs and the chunked
    backward from its checkpoints, each launching once."""
    zx, R, p, h0, c0, mask = _lstm_inputs(cuda, b, t, n, dtype, peephole,
                                          masked, seed=b + t + n + 1)
    g = torch.Generator(device=cuda).manual_seed(b * t)
    gs = [torch.randn(s, generator=g, device=cuda).to(dtype)
          for s in ((b, t, n), (b, n), (b, n))]
    counters = (lstm_scan_bwd, lstm_scan_chunked, lstm_scan_chunked_bwd)
    before = [c.launches for c in counters]
    fwd = lstm_scan_chunked_forward(zx, R, h0, c0, p, mask)
    d6 = lstm_scan_bwd(zx, R, h0, c0, fwd[0], *gs, p, mask)
    d8 = lstm_scan_chunked_bwd(zx, R, fwd[3], fwd[4], *gs, p, mask)
    torch.cuda.synchronize()
    assert [c.launches - x for c, x in zip(counters, before)] == [1, 1, 1]
    assert fwd[3].shape == (-(-t // CHUNK), b, n)
    _close_to("fwd", ("hs", "hT", "cT", "hck", "cck"), fwd,
              lstm_scan_chunked_reference(zx, R, h0, c0, p, mask))
    names = ("dzx", "dR", "dp", "dh0", "dc0")
    _close_to("bwd", names, d6, lstm_scan_backward_reference(
        zx, R, h0, c0, fwd[0], *gs, p, mask))
    _close_to("bwd", names, d8, lstm_scan_chunked_backward_reference(
        zx, R, fwd[3], fwd[4], *gs, p, mask))
    if masked:
        row = min(1, b - 1)  # fully masked: the carry's cotangent passes
        for d in (d6, d8):
            assert torch.equal(d[3][row], gs[1][row].float())
            assert torch.equal(d[4][row], gs[2][row].float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,n,masked", [
    (64, 64, 256, False),    # row 6 without a mask: z as one product
    (8, 64, 256, True),      # row 6 with a mask: the serial recompute
    (8, 1000, 256, False),   # row 8, a ragged last chunk (15 x 64 + 40)
    (9, 2 * CHUNK + 5, 64, True),
])
def test_lstm_backward_kernels_are_deterministic(cuda, b, t, n, masked,
                                                 dtype):
    """Rows 6 and 8 give the same bits over two calls on the same inputs:
    every sum has a fixed order, across the side streams and dR's K
    ranges too, and no atomics. Copies made on the current stream right
    after a call, with no synchronize, hold the same bits: the call joins
    its side streams back to the current stream before it returns."""
    zx, R, p, h0, c0, mask = _lstm_inputs(cuda, b, t, n, dtype, True,
                                          masked, seed=t + n)
    g = torch.Generator(device=cuda).manual_seed(t)
    gs = [torch.randn(s, generator=g, device=cuda).to(dtype)
          for s in ((b, t, n), (b, n), (b, n))]
    fwd = lstm_scan_chunked_forward(zx, R, h0, c0, p, mask)
    for run in (lambda: lstm_scan_bwd(zx, R, h0, c0, fwd[0], *gs, p, mask),
                lambda: lstm_scan_chunked_bwd(zx, R, fwd[3], fwd[4], *gs, p,
                                              mask)):
        first = run()
        read = [x.clone() for x in first]
        torch.cuda.synchronize()
        again = run()
        torch.cuda.synchronize()
        for a, r, c in zip(again, first, read):
            assert torch.equal(a, r)
            assert torch.equal(c, r)


@pytest.mark.cuda
def test_lstm_backward_workspace_does_not_grow_with_t(cuda):
    """Row 8's workspace holds two chunk slots however long the sequence;
    row 6's holds its whole t (one chunk)."""
    lib = lstm_ops._bwd_lib()
    b, n = 8, 256
    row8 = {lib.lstm_scan_bwd_workspace_floats(b, t, n, CHUNK)
            for t in (3 * CHUNK, 1000, 4096, 65536)}
    # R as float32 twice (the blocks' slices are unpadded at n = 256), the
    # dp sums, two slots of z, c and the h carry, four K ranges of dR
    slot = b * CHUNK * 6 * n
    assert row8 == {2 * 4 * n * n + 3 * b * n + 2 * slot + 4 * 4 * n * n}
    assert lib.lstm_scan_bwd_workspace_floats(64, 64, n, 64) == \
        2 * 4 * n * n + 3 * 64 * n + 64 * 64 * 6 * n + 8 * 4 * n * n
    assert lib.lstm_scan_bwd_workspace_floats(b, 4096, MAX_N + 1, CHUNK) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hck_shape", "cck_cpu", "g_hs_dtype"])
def test_lstm_backward_kernels_refuse_what_they_do_not_take(cuda, bad):
    zx, R, p, h0, c0, _ = _lstm_inputs(cuda, 2, 3, 8, torch.float32, True,
                                       False)
    hs, _, _, hck, cck = lstm_scan_chunked_forward(zx, R, h0, c0, p)
    gs = [torch.ones_like(a) for a in (hs, h0, c0)]
    if bad == "hck_shape":
        hck = torch.zeros(2, 2, 8, device=cuda)
    elif bad == "cck_cpu":
        cck = cck.cpu()
    else:
        gs[0] = gs[0].double()
    before = (lstm_scan_bwd.launches, lstm_scan_chunked_bwd.launches)
    with pytest.raises((TypeError, ValueError)):
        lstm_scan_chunked_bwd(zx, R, hck, cck, *gs, p)
    if bad == "g_hs_dtype":
        with pytest.raises((TypeError, ValueError)):
            lstm_scan_bwd(zx, R, h0, c0, hs, *gs, p)
    assert (lstm_scan_bwd.launches, lstm_scan_chunked_bwd.launches) == before


@pytest.mark.cuda
def test_lstm_autograd_on_the_card_launches_each_family(cuda):
    """Gradients through lstm_scan_peephole (rows 5, 6) and
    lstm_scan_chunked_peephole (rows 7, 8) on the card equal each other and
    the CPU's plain versions, at a t the chunk length does not divide."""
    zx, R, p, h0, c0, mask = _lstm_inputs(cuda, 5, CHUNK + 9, 32,
                                          torch.float32, True, True, seed=4)
    grads = {}
    for scan, counter in ((lstm_scan_peephole, lstm_scan_bwd),
                          (lstm_scan_chunked_peephole, lstm_scan_chunked_bwd)):
        for dev in (cuda, torch.device("cpu")):
            args = [a.detach().to(dev).requires_grad_()
                    for a in (zx, R, p, h0, c0)]
            before = counter.launches
            out = scan(*args, mask.to(dev))
            grads[(scan, dev.type)] = torch.autograd.grad(
                out[0].sum() + (out[2] * out[2]).sum(), args)
            assert counter.launches == before + (dev.type == "cuda")
    ref = grads[(lstm_scan_peephole, "cpu")]
    for key, got in grads.items():
        for a, r in zip(got, ref):
            assert float((a.cpu() - r).abs().max()) <= 1e-4 * max(
                1.0, float(r.abs().max())), key


@pytest.mark.cuda
@pytest.mark.parametrize("tbptt", [None, 8])
def test_rnn_fit_on_the_card_matches_the_cpu(cuda, tbptt):
    """Two RmsProp iterations of a TextGenerationLSTM cut to n = 32 (TF32
    off), by BPTT or in tBPTT windows of 8 over t = 16, on the card and on
    the CPU from the same seed: scores within 1e-5 relative, each param's
    change within 1e-5, the g2 slots within 1e-4 of each leaf's largest
    magnitude; each iteration launches rows 5 and 6 twice."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    nets = []
    for dev in ("cuda", "cpu"):
        conf = TextGenerationLSTM(num_classes=11, max_length=16,
                                  seed=5).conf()
        for layer in conf.layers[:2]:
            layer.n_out = 32
        if tbptt:
            conf.defaults.backprop_type = "tbptt"
            conf.defaults.tbptt_fwd_length = tbptt
        nets.append(MultiLayerNetwork(conf).init(device=dev))
    card, cpu = nets
    g = torch.Generator().manual_seed(12)
    ids = torch.randint(0, 11, (8, 17), generator=g)
    x = torch.nn.functional.one_hot(ids[:, :16], 11).float()
    y = torch.nn.functional.one_hot(ids[:, 1:], 11).float()
    start = {k: v.copy() for k, v in cpu.get_param_table().items()}
    before = (lstm_scan.launches, lstm_scan_bwd.launches)
    scores = {"card": [], "cpu": []}
    with dtypes.full_precision():
        for _ in range(1 if tbptt else 2):
            card.fit(DataSet(x.to(cuda), y.to(cuda)))
            scores["card"].append(card.score_)
            cpu.fit(DataSet(x, y))
            scores["cpu"].append(cpu.score_)
    torch.cuda.synchronize()
    assert card.iteration == cpu.iteration == 2
    assert (lstm_scan.launches - before[0],
            lstm_scan_bwd.launches - before[1]) == (4, 4)
    for a, b in zip(scores["card"], scores["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    tc, tp = card.get_param_table(), cpu.get_param_table()
    for k in tp:
        assert float(abs((tc[k] - start[k]) - (tp[k] - start[k])).max()) \
            <= 1e-5, k
    for a, b in zip(card.opt_state, cpu.opt_state):
        for path, leaf in flat_items(b["g2"]):
            got = dict(flat_items(a["g2"]))[path].cpu()
            assert float((got - leaf).abs().max()) <= 1e-4 * max(
                float(leaf.abs().max()), 1e-30), path


# ------------------------------------------------ routes and graph training
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["attention", "lstm"])
def test_shapes_the_kernels_refuse_run_on_the_card(cuda, kind):
    """A TransformerBlock of head dim 96 (outside flash_attention's head
    dims) and an LSTM of 1032 units (past the LSTM kernels' cap) run on
    the card, TF32 off, through sdpa and the per-step loop: the output and
    one SGD step agree with the CPU (outputs 1e-5 of their largest
    magnitude, scores 1e-5 relative, params 1e-5 absolute), and neither
    kernel family is launched."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutput, \
        TransformerBlock

    hidden, f = ((TransformerBlock(n_heads=1, causal=True), 96)
                 if kind == "attention"
                 else (LSTM(n_out=1032, activation="tanh"), 4))
    conf = NeuralNetConfiguration(seed=4, updater="sgd").list([
        hidden, RnnOutput(n_out=5, loss="mcxent", activation="softmax"),
    ]).set_input_type(it.recurrent(f, 6))
    nets = [MultiLayerNetwork(conf).init(device=d) for d in (cuda, "cpu")]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, f, generator=g)
    y = torch.nn.functional.one_hot(torch.randint(0, 5, (2, 6),
                                                  generator=g), 5).float()
    kernels = (flash_attention, lstm_scan, lstm_scan_chunked)
    before = [k.launches for k in kernels]
    with dtypes.full_precision():
        outs = [n.output(x.to(n.device)).cpu() for n in nets]
        for n in nets:
            n.fit(DataSet(x.to(n.device), y.to(n.device)))
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5 * float(
        outs[1].abs().max())
    assert abs(nets[0].score_ - nets[1].score_) <= 1e-5 * abs(nets[1].score_)
    tc, tp = (n.get_param_table() for n in nets)
    for k in tp:
        assert float(abs(tc[k] - tp[k]).max()) <= 1e-5, k


@pytest.mark.cuda
def test_graph_fit_step_on_the_card_matches_the_cpu(cuda):
    """One Nesterovs step (TF32 off) of the small ResNet-shaped graph
    (tests/torch_graphs.py) on the card and on the CPU from the same seed:
    score within 1e-5 relative, each param's change within 1e-5 absolute,
    the BN running stats and the Nesterovs slots within 1e-4 of each
    leaf's largest magnitude. The step launches bn_act once per BatchNorm
    (8) and the fused cross-entropy's forward and backward once each; the
    conv kernels' slots keep their channels_last layout."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph_conf import (
        ComputationGraphConfiguration,
    )
    from torch_graphs import small_resnet_json

    conf = ComputationGraphConfiguration.from_json(small_resnet_json())
    card = ComputationGraph(conf).init(device=cuda)
    cpu = ComputationGraph(conf).init(device="cpu")
    g = torch.Generator().manual_seed(9)
    x = torch.randn(4, 16, 16, 3, generator=g)
    y = torch.nn.functional.one_hot(torch.randint(0, 5, (4,), generator=g),
                                    5).float()
    start = cpu.get_param_table()
    counters = (bn_act, linear_xent_fwd, linear_xent_bwd)
    before = [c.launches for c in counters]
    with dtypes.full_precision():
        card.fit(DataSet(x.to(cuda), y.to(cuda)))
        cpu.fit(DataSet(x, y))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [8, 1, 1]
    assert abs(card.score_ - cpu.score_) <= 1e-5 * abs(cpu.score_)
    tc, tp = card.get_param_table(), cpu.get_param_table()
    for k in tp:
        got, want = tc[k] - start[k], tp[k] - start[k]
        assert float(abs(got - want).max()) <= 1e-5, k

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)

    for name, st in cpu.state.items():
        for k, v in st.items():
            assert rel(card.state[name][k], v) <= 1e-4, (name, k)
    for name, slots in cpu.opt_state.items():
        for path, v in flat_items(slots["v"]):
            assert rel(dict(flat_items(card.opt_state[name]["v"]))[path],
                       v) <= 1e-4, (name, path)
    assert card.opt_state["stem_conv"]["v"]["W"].is_contiguous(
        memory_format=torch.channels_last)


def _dropout_net(device, seed=3):
    """A small MultiLayerNetwork with dropout on a Dense layer and
    DropConnect on its Output, on `device`."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import Dense, Output
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect

    conf = NeuralNetConfiguration(seed=seed).list([
        Dense(n_out=64, activation="relu", dropout=0.6),
        Output(n_out=10, loss="mcxent", weight_noise=DropConnect(0.8)),
    ]).set_input_type(it.feed_forward(32)).build()
    return MultiLayerNetwork(conf).init(device=device)


def _dropout_batch(device):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(16, 32, generator=g)
    y = torch.nn.functional.one_hot(torch.randint(0, 10, (16,), generator=g),
                                    10).float()
    return DataSet(x.to(device), y.to(device))


@pytest.mark.cuda
def test_dropout_draws_on_the_card_repeat_from_the_network_seed(cuda):
    """The draws' generator lives on the card; two networks of one seed
    take the same masks (the same params bit for bit after 3 steps),
    another seed other masks."""
    nets = [_dropout_net(cuda), _dropout_net(cuda), _dropout_net(cuda, 4)]
    with torch.no_grad():
        for name, p in nets[0].params.items():
            for k, t in p.items():
                nets[2].params[name][k].copy_(t)
    assert nets[0].draws.generator.device.type == cuda.type
    data = _dropout_batch(cuda)
    with dtypes.full_precision():
        for net in nets:
            for _ in range(3):
                net.fit(data)
    t = [net.get_param_table() for net in nets]
    assert all((t[0][k] == t[1][k]).all() for k in t[0])
    assert any((t[0][k] != t[2][k]).any() for k in t[0])


@pytest.mark.cuda
def test_dropconnect_output_launches_linear_xent_once_each_way(cuda):
    """A DropConnect Output layer on the card: its noisy W goes through
    the fused cross-entropy, one forward and one backward launch per
    step, and the raw W moves."""
    net = _dropout_net(cuda)
    data = _dropout_batch(cuda)
    before_w = net.params["layer_1"]["W"].clone()
    counters = (linear_xent_fwd, linear_xent_bwd)
    before = [c.launches for c in counters]
    net.fit(data)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1]
    assert not torch.equal(net.params["layer_1"]["W"], before_w)


@pytest.mark.cuda
def test_keras_inception_v3_imported_onto_the_card_equals_the_cpu_import(
        cuda, tmp_path):
    """A 75x75 InceptionV3 file written by the port's writer and imported
    by import_keras_model_and_weights onto the card (the default) and onto
    the CPU: the same weights, every vertex within 1e-4 of its largest
    magnitude with TF32 off, and bn_act launched 94 times per forward."""
    import numpy as np

    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_model_and_weights,
    )
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        inception_preprocess,
        write_inception_v3_h5,
    )

    path = str(tmp_path / "iv3.h5")
    write_inception_v3_h5(path, (75, 75, 3), classes=10, seed=3)
    card = import_keras_model_and_weights(path)
    cpu = import_keras_model_and_weights(path, device="cpu")
    assert card.device.type == "cuda"
    tc, tp = card.get_param_table(), cpu.get_param_table()
    for k in tp:
        assert (tc[k] == tp[k]).all(), k
    x = inception_preprocess(np.random.default_rng(4).integers(
        0, 256, (2, 75, 75, 3)))
    before = bn_act.launches
    with dtypes.full_precision():
        got = card.feed_forward(x)
    torch.cuda.synchronize()
    assert bn_act.launches - before == 94
    want = cpu.feed_forward(x)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(
            float(w.abs().max()), 1e-30)


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.mark.cuda
def test_dl4j_zip_and_checkpoint_restore_onto_the_card(cuda):
    """Without device=, a DL4J zip (with its updater state) and a
    checkpoint zip land on the card, params, state and slots there, and
    give their committed outputs (TF32 off)."""
    import numpy as np

    from deeplearning4j_tpu_torch.modelimport import (
        restore_multi_layer_network,
    )
    from deeplearning4j_tpu_torch.models import restore_model

    dl4j = os.path.join(FIXTURES, "dl4j")
    exp = np.load(os.path.join(dl4j, "expected_outputs.npz"))
    net = restore_multi_layer_network(
        os.path.join(dl4j, "conv_pool_bn.zip"), it.convolutional(5, 5, 2),
        load_updater=True)
    ckpt = restore_model(os.path.join(FIXTURES, "mln_graves_lstm.zip"))
    cexp = np.load(os.path.join(FIXTURES, "expected_outputs.npz"))
    for n in (net, ckpt):
        assert n.device.type == "cuda"
        tensors = [t for p in (n.params, n.state) for v in p.values()
                   for _, t in flat_items(v)]
        tensors += [t for s in n.opt_state if s for _, t in flat_items(s)]
        assert tensors and all(t.is_cuda for t in tensors)
    before = bn_act.launches
    with dtypes.full_precision():
        got = net.output(exp["conv_x"]).cpu().numpy()
        got_c = ckpt.output(cexp["mln_graves_lstm_in"]).cpu().numpy()
    assert bn_act.launches == before + 1
    assert np.abs(got - exp["conv_y"]).max() <= 1e-5
    assert np.abs(got_c - cexp["mln_graves_lstm_out"]).max() <= 1e-5


def test_restore_onto_cuda_without_a_card_raises():
    """device="cuda" where torch.cuda.is_available() is False raises, for
    both restore paths."""
    from deeplearning4j_tpu_torch.modelimport import (
        restore_multi_layer_network,
    )
    from deeplearning4j_tpu_torch.models import restore_model

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_multi_layer_network(
            os.path.join(FIXTURES, "dl4j", "mlp_nesterovs.zip"),
            device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_model(os.path.join(FIXTURES, "mln_graves_lstm.zip"),
                      device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["graph", "dropout"])
def test_parallel_wrapper_over_nccl_at_world_size_1_matches_fit(
        cuda, tmp_path, kind):
    """ParallelWrapper at world size 1 over NCCL on the card against fit on
    the card, 3 steps from one seed, TF32 off: the small BatchNorm graph
    (global statistics through the differentiable all-reduce) and the
    dropout net (activation masks through the wrapper's rows, DropConnect
    alike); scores and params within 1e-5, running stats 1e-5 of each
    leaf's largest magnitude. Every step all-reduces every gradient and the
    score, one float32 bucket here."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec,
        ParallelWrapper,
        init_process_group,
    )
    from torch_graphs import small_resnet_json

    if kind == "graph":
        def make():
            return ComputationGraph(ComputationGraphConfiguration.from_json(
                small_resnet_json())).init(device=cuda)

        g = torch.Generator().manual_seed(5)
        data = DataSet(torch.randn(8, 16, 16, 3, generator=g).to(cuda),
                       torch.nn.functional.one_hot(torch.randint(
                           0, 5, (8,), generator=g), 5).float().to(cuda))
    else:
        def make():
            return _dropout_net(cuda)

        data = _dropout_batch(cuda)
    single, wrapped = make(), make()
    init_process_group(f"file://{tmp_path}/rdv", 0, 1)
    try:
        pw = ParallelWrapper(wrapped, mesh_spec=MeshSpec(data=1))
        assert pw.mesh.backend == "nccl" and pw.mesh.size == 1
        with dtypes.full_precision():
            for _ in range(3):
                single.fit(data)
                pw.fit(data)
                assert abs(wrapped.score_ - single.score_) <= 1e-5 * abs(
                    single.score_)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    a, b = single.get_param_table(), wrapped.get_param_table()
    for k in a:
        assert abs(b[k] - a[k]).max() <= 1e-5 * max(abs(a[k]).max(), 1), k
    for name, st in single.state.items():
        for k, v in st.items():
            w = wrapped.state[name][k]
            assert (w - v).abs().max() <= 1e-5 * v.abs().max(), (name, k)
    n = sum(v.size for v in a.values())
    assert pw.stats.steps == 3
    assert pw.stats.bytes == 3 * 4 * (n + 1)
    assert wrapped.iteration == 3
    assert wrapped.last_batch_size == data.num_examples()


def _ff_net(device, seed=3):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import Dense, Output

    return MultiLayerNetwork(NeuralNetConfiguration(
        seed=seed, updater=updaters.Nesterovs(learning_rate=0.05,
                                              momentum=0.9)).list([
            Dense(n_out=32, activation="relu"),
            Dense(n_out=16, activation="tanh"),
            Output(n_out=5, loss="mcxent")]).set_input_type(
        it.feed_forward(12))).init(device=device)


def _ff_data(n=64, seed=4):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 12)).astype(np.float32)
    return x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]


@pytest.mark.cuda
def test_async_iterator_fit_on_the_card(cuda):
    """fit over a host iterator on the card: the prefetch thread hands
    host batches, each goes to the card in the step, and the result is the
    CPU fit's (TF32 off, 1e-5); no prefetch thread survives fit."""
    import threading

    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    data = DataSet(*_ff_data())
    card, cpu = _ff_net(cuda), _ff_net("cpu")
    names = []

    class Source(ListDataSetIterator):
        def __next__(self):
            names.append(threading.current_thread().name)
            return ListDataSetIterator.__next__(self)

    with dtypes.full_precision():
        card.fit(Source(data, batch=16), epochs=2)
        cpu.fit(ListDataSetIterator(data, batch=16), epochs=2)
    torch.cuda.synchronize()
    assert card.iteration == cpu.iteration == 8
    assert names and all("prefetch" in n for n in names)
    assert not [t for t in threading.enumerate() if "prefetch" in t.name]
    a, b = card.get_param_table(), cpu.get_param_table()
    for k in a:
        assert abs(a[k] - b[k]).max() <= 1e-5 * max(abs(b[k]).max(), 1), k


@pytest.mark.cuda
def test_frozen_layer_step_on_the_card(cuda):
    """A network with its first two layers frozen by TransferLearning, 3
    steps on the card: the frozen params keep their bits and record no
    gradient, the Output's move as the CPU's do (TF32 off, 1e-5)."""
    from deeplearning4j_tpu_torch.models.transfer import TransferLearning

    data = DataSet(*_ff_data())
    card = TransferLearning(_ff_net(cuda)).set_feature_extractor(1).build()
    cpu = TransferLearning(_ff_net("cpu")).set_feature_extractor(1).build()
    assert card.device.type == "cuda"
    before = card.get_param_table()
    with dtypes.full_precision():
        for _ in range(3):
            card.fit(data)
            cpu.fit(data)
    torch.cuda.synchronize()
    after, ref = card.get_param_table(), cpu.get_param_table()
    for k in ("layer_0/W", "layer_0/b", "layer_1/W", "layer_1/b"):
        assert (after[k] == before[k]).all(), k
        assert not card.params[k.split("/")[0]][k.split("/")[1]].requires_grad
    assert not (after["layer_2/W"] == before["layer_2/W"]).all()
    for k in after:
        assert abs(after[k] - ref[k]).max() <= 1e-5 * max(
            abs(ref[k]).max(), 1), k


@pytest.mark.cuda
def test_evaluate_on_a_cuda_network(cuda):
    """evaluate, predict and the ROC / calibration family on a network on
    the card equal the CPU network's where no row's top two probabilities
    lie within 1e-4 (TF32 off)."""
    import numpy as np

    x, y = _ff_data(n=96)
    card, cpu = _ff_net(cuda), _ff_net("cpu")
    with dtypes.full_precision():
        p = cpu.output(x).numpy()
        top2 = np.sort(p, axis=-1)[:, -2:]
        keep = (top2[:, 1] - top2[:, 0]) >= 1e-4
        x, y = x[keep], y[keep]
        batches = [DataSet(x[i:i + 16], y[i:i + 16])
                   for i in range(0, len(x), 16)]
        ev_card, ev_cpu = card.evaluate(batches), cpu.evaluate(batches)
        assert ev_card.to_json() == ev_cpu.to_json()
        assert (card.predict(x) == cpu.predict(x)).all()
        roc_card = card.evaluate_roc_multi_class(batches, threshold_steps=50)
        roc_cpu = cpu.evaluate_roc_multi_class(batches, threshold_steps=50)
        assert abs(roc_card.calculate_average_auc()
                   - roc_cpu.calculate_average_auc()) <= 1e-3
        cal = card.evaluate_calibration(batches)
        assert int(cal.bin_count.sum()) == len(x) * 5
