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
on the card, each against the CPU; the layers of ROADMAP A.8's first half
(chip_smoke.py's layers-a8 cases: Deconv2D, SeparableConv2D, Conv1D,
pnorm over a zero window, the 1-D and resampling layers), Yolo2Output's
loss, gradient and decode (the threshold taken on the card) and
CenterLossOutput's steps, each against the CPU; layerwise pretraining of
each autoencoder-family case of chip_smoke.py's refer-pretrain
(AutoEncoder, binary and gaussian-visible RBMs, both VAEs) with the card's
draws replayed on the CPU, check_gradients in float64 on the card,
nan_checks around a step that launches the cross-entropy kernels; a
Router rollout over two LeNet versions on the card rolled back under
canary_nan with one bundle, and an Autoscaler pool on the card failing
over a replica whose dispatcher crashed; `cli train` on the card bit for
bit equal to a plain ParallelWrapper fit, and the stall watchdog firing
once during a card fit.

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


def _char_rnn(device, t=24):
    """The zoo TextGenerationLSTM at a cut width (GravesLSTM(32)), on
    `device`: rows 5, 6, 9 and 10 on the card."""
    conf = TextGenerationLSTM(num_classes=11, max_length=t, seed=3).conf()
    for layer in conf.layers[:2]:
        layer.n_out = 32
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    return MultiLayerNetwork(conf).init(device=device)


def _char_data(n=48, t=24, seed=6):
    import numpy as np

    ids = np.random.default_rng(seed).integers(0, 11, (n, t + 1))
    eye = np.eye(11, dtype=np.float32)
    return eye[ids[:, :t]], eye[ids[:, 1:]]


@pytest.mark.cuda
def test_step_window_on_the_card_equals_single_steps(cuda, monkeypatch):
    """DL4J_TPU_STEP_WINDOW=4 on the card: the char-RNN's 6 steps per
    epoch (a window of 4 and one of 2) equal the per-step loop's bit for
    bit, params, slots and scores, with the kernels launched as often."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize import CollectScoresListener

    data = DataSet(*_char_data())
    runs = []
    for window in ("1", "4"):
        monkeypatch.setenv("DL4J_TPU_STEP_WINDOW", window)
        net, col = _char_rnn(cuda), CollectScoresListener()
        net.set_listeners(col)
        lstm_ops.lstm_scan.launches = 0
        net.fit(ListDataSetIterator(data, batch=8), epochs=2)
        torch.cuda.synchronize()
        runs.append((net, col.scores, lstm_ops.lstm_scan.launches))
    (a, sa, la), (b, sb, lb) = runs
    assert sa == sb and len(sa) == 12 and la == lb == 24
    ta, tb = a.get_param_table(), b.get_param_table()
    for k in ta:
        assert (ta[k] == tb[k]).all(), k
    for x, y in zip(a.opt_state, b.opt_state):
        for (p, u), (_, v) in zip(flat_items(x["g2"]), flat_items(y["g2"])):
            assert torch.equal(u, v), p


@pytest.mark.cuda
def test_device_prefetch_side_stream_matches_a_synchronous_copy(
        cuda, monkeypatch):
    """The producer's copies (pinned memory, a side stream, an event the
    consumer's stream waits on) hand the consumer the same bits as a
    synchronous copy, while the consumer's stream is kept busy; and a fit
    under DL4J_TPU_DEVICE_PREFETCH=1 equals one without, bit for bit."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator,
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.training import engine

    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 256, 64)).astype(np.float32)
    y = rng.normal(size=(64, 8)).astype(np.float32)
    ait = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y), batch=8),
                               queue_size=3,
                               place=engine.to_device_async(cuda))
    got = []
    for ds in ait:
        assert ds.features.is_cuda and ds.on_arrival is None
        torch.cuda._sleep(1_000_000)  # the consumer's stream stays busy
        got.append((ds.features * 1.0, ds.labels.clone()))
    ait.shutdown()
    torch.cuda.synchronize()
    assert len(got) == 8
    for i, (f, l) in enumerate(got):
        assert torch.equal(f.cpu(), torch.from_numpy(x[8 * i:8 * i + 8]))
        assert torch.equal(l.cpu(), torch.from_numpy(y[8 * i:8 * i + 8]))
    data = DataSet(*_char_data(seed=9))
    nets = []
    for gate in ("0", "1"):
        monkeypatch.setenv("DL4J_TPU_DEVICE_PREFETCH", gate)
        net = _char_rnn(cuda)
        net.fit(ListDataSetIterator(data, batch=8), epochs=2)
        nets.append(net.get_param_table())
    torch.cuda.synchronize()
    for k in nets[0]:
        assert (nets[0][k] == nets[1][k]).all(), k


@pytest.mark.cuda
def test_lbfgs_iteration_on_the_card_matches_the_cpu(cuda):
    """Two LBFGS iterations of the char-RNN on the card (TF32 off), each
    started from the CPU's params and solver state: the accepted alpha
    equal, the params within 1e-5 of the largest."""
    import json

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    d = json.loads(_char_rnn("cpu").conf.to_json())
    d["defaults"]["optimization_algo"] = "lbfgs"
    card = MultiLayerNetwork(MultiLayerConfiguration.from_json(d)).init(
        device=cuda)
    cpu = MultiLayerNetwork(MultiLayerConfiguration.from_json(d)).init(
        device="cpu")
    x, y = _char_data(n=8)
    with dtypes.full_precision():
        for _ in range(2):
            card.set_param_table(cpu.get_param_table())
            if cpu._solver is not None:
                card._solver.optimizer._solver_state = {
                    k: v.to(cuda) if torch.is_tensor(v) else v
                    for k, v in cpu._solver.optimizer._solver_state.items()}
            cpu.fit(x, y)
            card.fit(x, y)
            torch.cuda.synchronize()
            assert (card._solver.optimizer.last_alpha
                    == cpu._solver.optimizer.last_alpha)
            a, b = card.get_param_table(), cpu.get_param_table()
            top = max(abs(v).max() for v in b.values())
            for k in a:
                assert abs(a[k] - b[k]).max() <= 1e-5 * top, k


@pytest.mark.cuda
def test_tf32_split_keeps_the_cards_nan(cuda):
    """The NaN the card's arithmetic makes (0x7fffffff) in x keeps its
    row's loss NaN through linear_xent's 3xTF32 products (it used to round
    to -0.0 there and read as zero), and the char-RNN's score on a batch
    of NaN features is NaN on the card, as on the CPU."""
    import numpy as np

    from deeplearning4j_tpu_torch.ops import xent_kernel as xk

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(64, 256, generator=g, device=cuda)
    bits = x.view(torch.int32)
    bits[3, 5] = 0x7fffffff
    bits[9, 0] = -1  # 0xffffffff
    w = torch.randn(256, 77, generator=g, device=cuda) * 0.05
    b = torch.zeros(77, device=cuda)
    labels = torch.nn.functional.one_hot(
        torch.arange(64, device=cuda) % 77, 77).float()
    per_row = xk.linear_xent_fwd(x, w, b, labels)[0]
    torch.cuda.synchronize()
    nan = torch.isnan(per_row).cpu()
    assert nan[3] and nan[9] and int(nan.sum()) == 2
    for device in (cuda, "cpu"):
        net = _char_rnn(device)
        x, y = _char_data(n=8)
        assert np.isnan(net.score(DataSet(np.full_like(x, np.nan), y)))


def _a8_cases():
    import chip_smoke

    return chip_smoke.A8_LAYER_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(35))
def test_a8_layer_on_the_card_matches_the_cpu(cuda, case):
    """chip_smoke.py's layers-a8 case `case`: forward and gradients on the
    card (TF32 off, deterministic cuDNN) within 1e-5 of the CPU's largest
    magnitude, NaN gradients at the same positions."""
    import numpy as np

    import chip_smoke

    cases = _a8_cases()
    assert len(cases) == 35
    label, cfg, shape, zero_window = cases[case]
    cpu = chip_smoke.a8_layer_run(torch, np, cfg, shape, zero_window, "cpu")
    with dtypes.full_precision(), chip_smoke.deterministic_cudnn(torch):
        card = chip_smoke.a8_layer_run(torch, np, cfg, shape, zero_window,
                                       cuda)
    pairs = [(card[0], cpu[0]), (card[1], cpu[1])] + [
        (card[2][k], cpu[2][k]) for k in cpu[2]]
    for got, want in pairs:
        assert chip_smoke.a8_disagreement(np, got, want) <= 1e-5, label


@pytest.mark.cuda
def test_yolo_loss_gradient_and_decode_on_the_card(cuda):
    """Yolo2Output's loss and gradient on the card within 1e-5 of the CPU's
    (relative); get_predicted_objects on a card tensor (threshold taken
    there) gives the CPU's list, in the same order."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        Yolo2Output,
        get_predicted_objects,
    )

    layer = Yolo2Output(boxes=[[1.0, 1.5], [1.0, 1.5], [2.5, 1.2]],
                        num_classes=3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5, 6, 24)).astype(np.float32)
    y = np.zeros((4, 5, 6, 7), np.float32)
    for i, r, c in ((0, 1, 2), (0, 3, 3), (2, 4, 5), (3, 0, 0)):
        cx, cy = (c + 0.5) / 6, (r + 0.5) / 5
        y[i, r, c, :4] = [cx - 0.1, cy - 0.1, cx + 0.2, cy + 0.1]
        y[i, r, c, 4 + (i + r) % 3] = 1.0
    out = {}
    for dev in ("cpu", cuda):
        tx = torch.tensor(x, device=dev, requires_grad=True)
        score, _, _ = layer.compute_loss({}, tx, torch.tensor(y, device=dev),
                                         state={})
        score.backward()
        out[str(dev)] = (score.item(), tx.grad.cpu().numpy(),
                         get_predicted_objects(layer, tx.detach(), 0.6))
    (s_cpu, g_cpu, o_cpu), (s_card, g_card, o_card) = out.values()
    assert abs(s_card - s_cpu) <= 1e-5 * abs(s_cpu)
    assert np.abs(g_card - g_cpu).max() <= 1e-5 * np.abs(g_cpu).max()
    assert len(o_cpu) > 3
    assert [(o.example, o.predicted_class) for o in o_card] == \
        [(o.example, o.predicted_class) for o in o_cpu]
    for a, b in zip(o_card, o_cpu):
        assert abs(a.confidence - b.confidence) <= 1e-6
        assert abs(a.center_x - b.center_x) <= 1e-5


@pytest.mark.cuda
def test_center_loss_output_step_on_the_card(cuda):
    """Three fit steps of a Dense -> CenterLossOutput network on the card
    (TF32 off) and on the CPU: scores 1e-5 relative, params and centers
    1e-5 absolute; the second batch lacks class 2, whose center stays."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import CenterLossOutput, Dense

    def net(dev):
        return MultiLayerNetwork(NeuralNetConfiguration(
            seed=3, updater=updaters.Adam(learning_rate=1e-2)).list([
                Dense(n_out=8, activation="tanh"),
                CenterLossOutput(n_out=4, loss="mcxent", alpha=0.5,
                                 lambda_=0.1)]).set_input_type(
            it.feed_forward(6))).init(dev)

    nets = {"card": net(cuda), "cpu": net("cpu")}
    rng = np.random.default_rng(1)
    for step in range(3):
        x = rng.standard_normal((16, 6)).astype(np.float32)
        cls = rng.integers(0, 4, 16)
        if step == 1:
            cls[cls == 2] = 0
        y = np.eye(4, dtype=np.float32)[cls]
        before = nets["card"].state["layer_1"]["centers"].clone()
        with dtypes.full_precision():
            for n in nets.values():
                n.fit(DataSet(x, y))
        assert abs(nets["card"].score_ - nets["cpu"].score_) <= \
            1e-5 * abs(nets["cpu"].score_)
        c_card = nets["card"].state["layer_1"]["centers"]
        c_cpu = nets["cpu"].state["layer_1"]["centers"]
        assert (c_card.cpu() - c_cpu).abs().max() <= 1e-5
        if step == 1:
            assert torch.equal(c_card[2], before[2])
    ta, tb = nets["card"].get_param_table(), nets["cpu"].get_param_table()
    for k in tb:
        assert abs(ta[k] - tb[k]).max() <= 1e-5, k


def _pretrain_refer_cases():
    import chip_smoke

    return chip_smoke.PRETRAIN_REFER_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
def test_pretrain_layer_on_the_card_matches_the_cpu(cuda, case):
    """chip_smoke.py's refer-pretrain case `case` at full width on 3
    batches of 128 seeded rows in [0, 1): card (TF32 off) vs CPU from the
    same params with the card's draws replayed, within
    chip_smoke.PRETRAIN_REFER_TOL."""
    import numpy as np

    import chip_smoke

    assert len(_pretrain_refer_cases()) == 5
    rng = np.random.default_rng(case)
    n = chip_smoke.PRETRAIN[0] * chip_smoke.PRETRAIN_REFER_BATCHES
    x = torch.tensor(rng.random((n, 784), dtype=np.float32), device=cuda)
    y = torch.nn.functional.one_hot(
        torch.tensor(rng.integers(0, 10, n), device=cuda), 10).float()
    errs, line = chip_smoke.pretrain_refer_case(torch, np, case, x, y)
    for k, v in errs.items():
        assert v <= chip_smoke.PRETRAIN_REFER_TOL[k], line


@pytest.mark.cuda
def test_check_gradients_on_the_card(cuda):
    """check_gradients passes on float64 AutoEncoder, RBM and VAE networks
    on the card, their analytic gradients within 1e-10 of the CPU's."""
    import numpy as np

    import chip_smoke

    chip_smoke.phase_gradient_checks(torch, np)


@pytest.mark.cuda
def test_nan_checks_around_the_cross_entropy_kernels(cuda):
    """A fit step of an RBM -> Output network on the card (the xent
    kernels launched once each way) passes under nan_checks; a NaN input
    raises FloatingPointError in output."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import RBM, Output
    from deeplearning4j_tpu_torch.util.debugging import nan_checks

    net = MultiLayerNetwork(NeuralNetConfiguration(seed=1).list([
        RBM(n_out=32), Output(n_out=10, loss="mcxent")]).set_input_type(
        it.feed_forward(40))).init(cuda)
    rng = np.random.default_rng(0)
    x = rng.random((16, 40)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    before = (linear_xent_fwd.launches, linear_xent_bwd.launches)
    with nan_checks():
        net.fit(DataSet(x, y))
        assert (linear_xent_fwd.launches, linear_xent_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
        x[2, 5] = np.nan
        with pytest.raises(FloatingPointError):
            net.output(x)


# ---------------------------------------------- the model and fsdp axes
def _spawn_worker_ranks(tmp_path, world, cases):
    """`world` ranks of tests/torch_dp_worker.py on the card (gloo with
    CUDA tensors: NCCL refuses two ranks on one device) running `cases`
    ({name: spec}) in one process group; each rank's results per case."""
    import json
    import subprocess
    import sys

    import numpy as np

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_dp_worker.py")
    procs = []
    for r in range(world):
        spec = {"rank": r, "world": world, "init": f"file://{tmp_path}/rdv",
                "cases": [dict(c, device="cuda",
                               out=str(tmp_path / f"{n}_rank{r}.npz"))
                          for n, c in cases.items()]}
        path = tmp_path / f"spec{r}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen([sys.executable, worker, str(path)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return {n: [dict(np.load(tmp_path / f"{n}_rank{r}.npz"))
                for r in range(world)] for n in cases}


@pytest.mark.cuda
def test_gloo_collectives_and_model_axis_functions_on_the_card(cuda,
                                                               tmp_path):
    """Two ranks on the one card over gloo: all_gather and all_reduce of
    CUDA tensors, and the gradients through Megatron's f (copy: the
    cotangent summed over the ranks), g (reduce: the sum forward, the
    cotangent as it is) and the gather (this rank's slice of the
    cotangent), exactly, each against what one process computes."""
    import numpy as np

    ranks = _spawn_worker_ranks(tmp_path, 2, {"probe": {"probe": True}})[
        "probe"]
    w = np.arange(8, dtype=np.float32) + 1
    for r, res in enumerate(ranks):
        assert str(res["device"]).startswith("cuda")
        np.testing.assert_array_equal(
            res["all_gather"], np.concatenate([np.arange(4),
                                               np.arange(4) + 10]))
        np.testing.assert_array_equal(res["all_reduce"],
                                      2 * np.arange(4) + 10)
        np.testing.assert_array_equal(res["copy/grad"], 3 * w)
        np.testing.assert_array_equal(res["reduce/y"], 3 * np.arange(8))
        np.testing.assert_array_equal(res["reduce/grad"], (r + 1) * w)
        np.testing.assert_array_equal(res["gather/y"],
                                      np.arange(8) * np.repeat([1, 2], 4))
        np.testing.assert_array_equal(res["gather/grad"],
                                      (r + 1) * w[4 * r:4 * r + 4])


@pytest.mark.cuda
def test_model_axis_on_the_card_matches_one_process(cuda, tmp_path):
    """Two ranks at MeshSpec(model=2) on the card (gloo), TF32 off, 3
    steps of a Dense MLP, a small TransformerLM (2 of its 4 heads per
    rank through the flash rows, the Output gathered for rows 9 and 10)
    and an LSTM (W, R, b gathered for rows 5 and 6), against fit in this
    process on the card: scores 1e-5 relative, params 1e-5 absolute; the
    ranks bit-identical; each rank launches what one process launches."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn.conf import (
        MultiLayerConfiguration,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        LSTM,
        Dense,
        Output,
        RnnOutput,
    )
    from torch_dp_worker import launch_counts

    rng = np.random.default_rng(3)
    confs = {
        "mlp": NeuralNetConfiguration(
            seed=11, updater=updaters.Adam(learning_rate=5e-3)).list([
                Dense(n_out=32, activation="relu"),
                Output(n_out=4, loss="mcxent")]).set_input_type(
            it.feed_forward(8)),
        "lm": TransformerLM(num_classes=64, max_length=32, d_model=64,
                            n_heads=4, n_layers=2, seed=5).conf(),
        "lstm": NeuralNetConfiguration(
            seed=5, updater=updaters.Adam(learning_rate=5e-3)).list([
                LSTM(n_out=32, activation="tanh"),
                RnnOutput(n_out=12, loss="mcxent")]).set_input_type(
            it.recurrent(12, 10)),
    }
    data = {
        "mlp": (rng.standard_normal((8, 8)).astype(np.float32),
                np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]),
        "lm": (rng.integers(0, 64, (4, 32)).astype(np.float32),
               np.eye(64, dtype=np.float32)[rng.integers(0, 64, (4, 32))]),
        "lstm": (rng.standard_normal((8, 10, 12)).astype(np.float32),
                 np.eye(12, dtype=np.float32)[rng.integers(0, 12,
                                                           (8, 10))]),
    }
    cases = {}
    for name, conf in confs.items():
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, x=data[name][0], y=data[name][1])
        cases[name] = dict(kind="mln", conf=conf.to_json(), data=path,
                           batch=data[name][0].shape[0], epochs=3,
                           mesh={"model": 2}, full_precision=True)
    ranks = _spawn_worker_ranks(tmp_path, 2, cases)
    for name, conf in confs.items():
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json())).init(cuda)
        before = launch_counts()
        scores = []
        with dtypes.full_precision():
            for _ in range(3):
                net.fit(DataSet(*data[name]))
                scores.append(net.score_)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        r0, r1 = ranks[name]
        for k in r0:
            if k.startswith(("param/", "slot/", "scores")):
                np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0["scores"], scores, rtol=1e-5)
        for k, v in net.get_param_table().items():
            np.testing.assert_allclose(r0[f"param/{k}"], v, atol=1e-5,
                                       err_msg=f"{name} {k}")
        assert {k[len("launches/"):]: int(v) for k, v in r0.items()
                if k.startswith("launches/")} == launches, name
        assert launches["linear_xent_fwd"] == 3
    assert any(int(v) < ranks["lm"][0][f"param/{k[len('local/param/'):]}"]
               .size for k, v in ranks["lm"][0].items()
               if k.startswith("local/param/"))


@pytest.mark.cuda
def test_remat_under_the_data_axis_on_the_card_matches_no_remat(cuda,
                                                                 tmp_path):
    """Two ranks at MeshSpec(data=2) on the card (gloo), TF32 off, 3 steps
    of an MLP with BatchNorm (global statistics through all_sum_grad),
    scheduled dropout (each rank's rows of the whole-batch mask, p moving
    with the iteration) and scheduled DropConnect, every layer at remat
    'full' and 'dots_saveable' against 'none'. On the card the backward,
    and so the recompute, runs on autograd's device thread: it must take
    the step's batch shard and iteration. Scores, params and running
    state 1e-6."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn import dropout as tdrop
    from deeplearning4j_tpu_torch.nn import schedules as tsched
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn import weightnoise as twn
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import BatchNorm, Dense, Output

    conf = NeuralNetConfiguration(
        seed=9, updater=updaters.Adam(learning_rate=5e-3)).list([
            Dense(n_out=64, activation="identity",
                  dropout=tdrop.Dropout(
                      p=0.8, p_schedule=tsched.MapSchedule({1: 0.6})),
                  weight_noise=twn.DropConnect(
                      p=0.9, p_schedule=tsched.ExponentialSchedule(0.9))),
            BatchNorm(activation="relu"),
            Dense(n_out=32, activation="tanh", dropout=0.7),
            Output(n_out=8, loss="mcxent")]).set_input_type(
        it.feed_forward(16))
    rng = np.random.default_rng(4)
    data = str(tmp_path / "mlp.npz")
    np.savez(data, x=rng.standard_normal((32, 16)).astype(np.float32),
             y=np.eye(8, dtype=np.float32)[rng.integers(0, 8, 32)])
    case = dict(kind="mln", conf=conf.to_json(), data=data, batch=32,
                epochs=3, mesh={"data": 2}, full_precision=True)
    ranks = _spawn_worker_ranks(tmp_path, 2, {
        pol: dict(case, remat=pol) for pol in ("none", "full",
                                               "dots_saveable")})
    plain = ranks["none"][0]
    assert np.isfinite(plain["scores"]).all()
    for pol in ("full", "dots_saveable"):
        for r, got in enumerate(ranks[pol]):
            np.testing.assert_allclose(got["scores"], plain["scores"],
                                       rtol=1e-6, err_msg=f"{pol} {r}")
            for k in plain:
                if k.startswith(("param/", "state/")):
                    np.testing.assert_allclose(got[k], plain[k], atol=1e-6,
                                               err_msg=f"{pol} {r} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 4, 512, 64), (4, 2, 32, 16)])
def test_flash_rows_on_half_the_heads_match_plain_version(cuda, shape,
                                                          dtype):
    """Rows 2-4 at the local shapes of a model-split attention (n_heads /
    2 heads per rank: the full-width TransformerLM's 4 of 8, and the card
    test's 2 of 4), causal, against their plain versions."""
    _flash_check(cuda, shape, True, dtype, True)
    _flash_bwd_check(cuda, shape, True, dtype)


# ---------------------------------------------- the seq axis's ring
@pytest.mark.cuda
def test_ring_over_two_gloo_ranks_matches_one_process_rows_2_to_4(
        cuda, tmp_path):
    """Ring attention over two ranks on the card (gloo, each hop staged
    through a host buffer) at (2, 4, 512, 64), causal and not, float32
    and bfloat16: the output and the gradients of sum(o * w) against one
    process's flash forward and backward kernels over the whole sequence,
    at the flash tests' tolerances (x max|plain|: forward float32 1e-5,
    bfloat16 2e-2; backward 1e-4 and 1e-2); rank r launches each of rows
    2-4 r + 1 times on a causal ring, twice on a full one."""
    import numpy as np

    rng = np.random.default_rng(17)
    shape = (2, 4, 512, 64)
    cases, inputs = {}, {}
    for causal in (True, False):
        for dtype in ("float32", "bfloat16"):
            name = f"{'causal' if causal else 'full'}_{dtype}"
            arrays = {n: rng.standard_normal(shape).astype(np.float32)
                      for n in ("q", "k", "v", "w")}
            path = str(tmp_path / f"{name}.npz")
            np.savez(path, **arrays)
            inputs[name] = arrays
            cases[name] = dict(ring=True, mesh={"seq": 2}, causal=causal,
                               dtype=dtype, data=path)
    ranks = _spawn_worker_ranks(tmp_path, 2, cases)
    tol = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 1e-2)}
    for name, arrays in inputs.items():
        causal, dtype = name.startswith("causal"), name.split("_")[1]
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(arrays[n]).to(cuda, dt)
                   .requires_grad_(True) for n in ("q", "k", "v"))
        o = flash_attention(q, k, v, causal)
        (o.float() * torch.from_numpy(arrays["w"]).to(cuda)).sum().backward()
        want = {"o": o, "dq": q.grad, "dk": k.grad, "dv": v.grad}
        for r, res in enumerate(ranks[name]):
            assert bool(res["kernel_route"])
            for n, ref in want.items():
                t = tol[dtype][0 if n == "o" else 1]
                ref = ref.detach().float().cpu().numpy()
                err = float(np.abs(res[n] - ref).max())
                assert err <= t * float(np.abs(ref).max()), (name, r, n, err)
            hops = r + 1 if causal else 2
            for row in ("flash_attention", "flash_attention_bwd_dq"):
                assert int(res[f"launches/{row}"]) == hops, (name, r, row)


# ---------------------------------------------- ParallelInference, the registry
def _bn_graph(device):
    """conv -> BatchNorm(relu) -> average pool -> Output at 9x9x3: one
    bn_act launch per forward."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNorm,
        Conv2D,
        GlobalPooling,
        Output,
    )

    conf = (NeuralNetConfiguration(seed=3).graph().add_inputs("in")
            .add_layer("c", Conv2D(kernel_size=(3, 3), stride=(2, 2), n_out=8,
                                   convolution_mode="same", has_bias=False),
                       "in")
            .add_layer("bn", BatchNorm(activation="relu"), "c")
            .add_layer("pool", GlobalPooling(pooling_type="avg"), "bn")
            .add_layer("out", Output(n_out=5), "pool")
            .set_outputs("out")
            .set_input_types(it.convolutional(9, 9, 3)))
    return ComputationGraph(conf).init(device=device)


class _Counted:
    """Counts the forwards of `net` that return (an instance attribute
    over its output)."""

    def __init__(self, net):
        self.net, self.direct, self.n = net, net.output, 0
        net.output = self

    def __call__(self, x):
        out = self.direct(x)
        self.n += 1
        return out

    def restore(self):
        self.net.output = self.direct


@pytest.mark.cuda
@pytest.mark.parametrize("mode,gate", [("batched", False),
                                       ("instant", False),
                                       ("batched", True)])
def test_parallel_inference_on_the_card_matches_output(cuda, monkeypatch,
                                                       mode, gate):
    """ParallelInference on the model's own card, both modes with the
    DL4J_TPU_SERVING gate off and BATCHED with it on, TF32 off: requests
    of 1, 3 and 8 rows at once, each within 1e-5 of net.output on its
    rows; a request of another trailing shape fails alone; bn_act
    launches once per dispatched batch."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from deeplearning4j_tpu_torch.parallel import ParallelInference

    if gate:
        monkeypatch.setenv("DL4J_TPU_SERVING", "1")
    else:
        monkeypatch.delenv("DL4J_TPU_SERVING", raising=False)
    net = _bn_graph(cuda)
    rng = np.random.default_rng(31)
    xs = [rng.standard_normal((n, 9, 9, 3)).astype(np.float32)
          for n in (1, 3, 8)]
    bad = np.zeros((2, 9, 9, 4), np.float32)
    with dtypes.full_precision():
        refs = [net.output(x).cpu().numpy() for x in xs]
        counted = _Counted(net)
        before = bn_act.launches
        pi = ParallelInference(net, mode=mode, batch_limit=8)

        def call(x):
            try:
                return pi.output(x, deadline_s=60.0)
            except Exception as e:
                return e

        try:
            with ThreadPoolExecutor(4) as pool:
                outs = list(pool.map(call, xs + [bad]))
        finally:
            pi.shutdown()
            counted.restore()
    assert isinstance(outs[-1], Exception)
    for out, ref in zip(outs, refs):
        assert np.abs(out - ref).max() <= 1e-5
    assert counted.n >= 1
    assert bn_act.launches - before == counted.n


@pytest.mark.cuda
def test_registry_serves_a_transformer_lm_checkpoint_on_the_card(
        cuda, monkeypatch, tmp_path):
    """A small TransformerLM written by write_model, resolved by a
    ModelRegistry onto the card (device None), warmed from an example and
    then by a second registry from its manifest alone, served with the
    DL4J_TPU_SERVING gate on and through ParallelInference (the gate
    routes it through the serving runtime): answers within 1e-5 of the
    largest probability of net.output (TF32 off); flash_attention
    launches twice (two blocks) per dispatched batch."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import write_model
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import ModelRegistry

    monkeypatch.setenv("DL4J_TPU_SERVING", "1")
    path = str(tmp_path / "lm.zip")
    write_model(TransformerLM(num_classes=64, max_length=32, d_model=64,
                              n_heads=4, n_layers=2, seed=3).init(
                                  device=cuda), path, save_updater=False)
    ids = np.random.default_rng(8).integers(0, 64, (3, 32)).astype(np.int32)
    warm = str(tmp_path / "warm")
    reg = ModelRegistry(warm_cache_dir=warm)
    reg2 = None
    with dtypes.full_precision():
        try:
            mv = reg.register("lm", path, batch_limit=4)
            net = mv.server.model
            assert net.device.type == "cuda"
            ref = net.output(ids).cpu().numpy()
            counted = _Counted(net)
            before = flash_attention.launches
            reg.warm("lm", example=ids[:1])
            got = [mv.server.output(ids, deadline_s=60.0)]
            reg2 = ModelRegistry(warm_cache_dir=warm)
            mv2 = reg2.register("lm", net, batch_limit=4)
            reg2.warm("lm")
            assert {b for _, b in mv2.server.warmed_rows} == {1, 2, 4}
            got.append(mv2.server.output(ids, deadline_s=60.0))
            pi = ParallelInference(net, batch_limit=4)
            try:
                assert pi._serving is not None
                got.append(pi.output(ids, deadline_s=60.0))
            finally:
                pi.shutdown()
            counted.restore()
        finally:
            reg.shutdown()
            if reg2 is not None:
                reg2.shutdown()
    for out in got:
        assert out.shape == (3, 32, 64)
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert flash_attention.launches - before == 2 * counted.n
    assert counted.n == 3 + 3 + 1 + 1 + 1  # warmups, then the requests


@pytest.mark.cuda
def test_parallel_inference_over_two_gloo_ranks_on_the_card(cuda,
                                                            tmp_path):
    """zoo LeNet's config on a data=2 grid of two gloo ranks on the card:
    rank 0 dispatches each padded batch, rank 1 follows; BATCHED and
    INSTANT with the gate off, BATCHED with it on; rank 0's answers within
    1e-5 of this process's net.output (the same seeded weights, TF32 off
    in both: cuDNN picks its algorithm by the batch's rows)."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.zoo import LeNet

    conf = LeNet().conf().to_json()
    xs = [np.random.default_rng(40 + n).standard_normal(
        (n, 28, 28, 1)).astype(np.float32) for n in (1, 3, 4)]
    data = str(tmp_path / "requests.npz")
    np.savez(data, **{f"x{i}": x for i, x in enumerate(xs)})
    base = dict(pi=True, kind="mln", conf=conf, data=data, batch_limit=8,
                mesh={"data": 2}, full_precision=True)
    ranks = _spawn_worker_ranks(tmp_path, 2, {
        "batched": dict(base, mode="batched"),
        "instant": dict(base, mode="instant"),
        "serving": dict(base, mode="batched", serving=True)})
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf)).init(
        device=cuda)
    with dtypes.full_precision():
        refs = [net.output(x).cpu().numpy() for x in xs]
    for name, (r0, r1) in ranks.items():
        assert int(r1["served"]) >= 1, name
        for i, ref in enumerate(refs):
            assert np.abs(r0[f"out{i}"] - ref).max() <= 1e-5, (name, i)


def _lenet_versions(device):
    from deeplearning4j_tpu_torch.zoo import LeNet

    return {"v1": LeNet(seed=1).init(device=device),
            "v2": LeNet(seed=2).init(device=device)}


@pytest.mark.cuda
def test_router_rollout_on_the_card_rolls_back_under_canary_nan(
        cuda, monkeypatch, tmp_path):
    """Two LeNet versions on the card behind a registry and a Router: at
    the first stage (50%) the counter split sends every second request to
    the canary; with DL4J_TPU_CHAOS=canary_nan on every canary batch the
    canary's answers fail typed (non-finite, then the canary's open
    breaker), the next evaluate() tick rolls back and
    writes exactly one canary_rollback bundle, and every stable answer
    (and every answer after the rollback) is v1's net.output within 1e-5
    (TF32 off)."""
    import numpy as np

    from deeplearning4j_tpu_torch.resilience import chaos
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        Router,
        ServingError,
    )
    from deeplearning4j_tpu_torch.telemetry import flight, trace

    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_TPU_CHAOS", "canary_nan@" + ":".join(
        str(i) for i in range(1, 40)))
    chaos.reset_fault_points()
    trace.configure(enabled=True)
    nets = _lenet_versions(cuda)
    xs = [np.random.default_rng(i).standard_normal(
        (1 + i % 3, 28, 28, 1)).astype(np.float32) for i in range(12)]
    reg = ModelRegistry()
    try:
        with dtypes.full_precision():
            for v, net in nets.items():
                reg.register("m", net, version=v, stable=v == "v1",
                             batch_limit=4)
            rt = Router(reg)
            ro = rt.start_rollout("m", "v2", stages=(0.5, 1.0),
                                  min_requests=50, fast_window_s=60.0,
                                  slow_window_s=600.0)
            rt.evaluate(now=0.0)
            got = []
            for x in xs:
                try:
                    got.append(rt.output("m", x, deadline_s=60.0))
                except ServingError as e:
                    got.append(e)
            rt.evaluate(now=61.0)
            after = rt.output("m", xs[0], deadline_s=60.0)
            refs = [nets["v1"].output(x).cpu().numpy() for x in xs]
    finally:
        reg.shutdown()
        trace.configure(enabled=None)
        chaos.reset_fault_points()
    assert [isinstance(g, Exception) for g in got] == [False, True] * 6
    for g, ref in zip(got[::2], refs[::2]):
        assert np.abs(g - ref).max() <= 1e-5
    assert np.abs(after - refs[0]).max() <= 1e-5
    assert ro.state == "rolled_back" and ro.history == ["50", "rollback"]
    bundles = [p for p in flight.list_bundles(str(tmp_path))
               if "canary_rollback" in p]
    assert bundles == [ro.rollback_bundle]
    doc = flight.load_bundle(bundles[0])
    assert len(doc["canary"]["offending_traces"]) == 6
    assert doc["runtime"]["local_devices"][0] == torch.cuda.get_device_name(
        0)


@pytest.mark.cuda
def test_autoscaler_fails_over_a_crashed_replica_on_the_card(cuda, tmp_path):
    """Autoscaler.for_model over LeNet on the card with a warm manifest:
    two replicas share the network's weights, each warmed from the
    manifest; one replica's dispatcher dies (an exception that escapes
    Exception, as a crash does); every call still returns net.output
    within 1e-5 (requeued onto the survivor), the dead replica is evicted
    with reason crash, and the next evaluate() restores min_replicas."""
    import warnings

    import numpy as np

    from deeplearning4j_tpu_torch.serving import Autoscaler, ModelRegistry

    net = _lenet_versions(cuda)["v1"]
    reg = ModelRegistry(warm_cache_dir=str(tmp_path / "warm"))
    pool = None
    x = np.random.default_rng(3).standard_normal(
        (2, 28, 28, 1)).astype(np.float32)
    try:
        with dtypes.full_precision():
            reg.register("m", net, batch_limit=4)
            reg.warm("m", example=x[:1])
            pool = Autoscaler.for_model(reg, "m", min_replicas=2,
                                        max_replicas=3, min_dwell_s=0.0,
                                        clock=lambda: 0.0)
            reps = list(pool._replicas)
            assert len(reps) == 2 and all(
                sorted(b for _, b in r.server.warmed_rows) == [1, 2, 4]
                for r in reps)
            victim = reps[0]
            inner = victim.server._dispatch

            def dying(xp):
                raise SystemExit("replica dispatcher died")

            victim.server._dispatch = dying
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                outs = [pool.output(x, deadline_s=60.0) for _ in range(6)]
                pool.evaluate(now=1.0)
                pool.evaluate(now=2.0)
            ref = net.output(x).cpu().numpy()
            victim.server._dispatch = inner
    finally:
        if pool is not None:
            pool.shutdown()
        reg.shutdown()
    for out in outs:
        assert np.abs(out - ref).max() <= 1e-5
    info = pool.membership.get(victim.replica_id)
    assert info.state.value == "evicted" and info.evict_reason == "crash"
    assert any(e["reason"] == "crash" for e in pool._events)
    assert sum(e["direction"] == "out" for e in pool._events) >= 3


@pytest.mark.cuda
def test_cli_train_on_the_card_equals_a_plain_wrapper_fit(cuda, tmp_path):
    """`cli train` with no --device trains on the card (a NCCL group of
    one it starts and closes) and saves params bit for bit equal to a
    plain ParallelWrapper.fit of the same zip and CSV, under
    deterministic cuDNN: the CLI adds only listeners and telemetry."""
    import sys

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models import restore_model
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper,
        init_process_group,
    )

    model, out = str(tmp_path / "m.zip"), str(tmp_path / "out.zip")
    csv = str(tmp_path / "d.csv")
    chip_smoke.lenet_flat_zip(torch, model)
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.integers(0, 256, (256, 784)) / 255.0,
                           rng.integers(0, 10, (256, 1))], 1)
    np.savetxt(csv, rows, delimiter=",", fmt="%.6g")
    with chip_smoke.deterministic_cudnn(torch):
        assert cli.main(["train", "--model", model, "--data", csv,
                         "--num-classes", "10", "--batch", "64", "--out",
                         out]) == 0
        init_process_group(f"file://{tmp_path}/rdv", 0, 1)
        try:
            ref = restore_model(model)
            pw = ParallelWrapper(ref)
            pw.fit(RecordReaderDataSetIterator(
                CSVRecordReader(csv), batch=64, label_index=-1,
                num_classes=10))
            pw.sync_to_host()
        finally:
            torch.distributed.destroy_process_group()
    got = restore_model(out)
    assert got.device.type == "cuda" and got.iteration == 4
    a, b = got.get_param_table(), ref.get_param_table()
    assert sorted(a) == sorted(b)
    for k in b:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.cuda
def test_stall_watchdog_fires_once_during_a_card_fit(cuda, monkeypatch,
                                                     tmp_path):
    """A LeNet fit on the card whose third step's listener sleeps past
    DL4J_TPU_STALL_TIMEOUT: one stall, one stall bundle, healthz stalled
    during it and live after the next beat."""
    import time

    import numpy as np

    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.telemetry import flight, health, metrics
    from deeplearning4j_tpu_torch.zoo import LeNet

    net = LeNet(seed=1).init()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 256)]
    # a first fit with the gate off: the card's first steps of a new
    # network (cuDNN's choices) must not read as a stall
    net.fit(ListDataSetIterator(DataSet(x, y), batch=64))
    monkeypatch.setenv("DL4J_TPU_TELEMETRY", "1")
    monkeypatch.setenv("DL4J_TPU_STALL_TIMEOUT", "0.3")
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    health.reset_for_tests()
    metrics.registry().reset()
    snaps = []

    class Sleepy:
        calls = 0

        def iteration_done(self, model, iteration, score):
            self.calls += 1
            if self.calls == 3:
                time.sleep(1.0)
                snaps.append(health.healthz())

    net.set_listeners(Sleepy())
    net.fit(ListDataSetIterator(DataSet(x, y), batch=64))
    after = health.healthz()
    health.reset_for_tests()
    assert metrics.registry().get(
        "dl4j_tpu_stall_detected_total").snapshot() == {
        "phase=MultiLayerNetwork.fit": 1.0}
    assert snaps[0]["stalled"] is True and snaps[0]["ok"] is False
    assert after["ok"] is True and after["iteration"] == 8
    assert len([p for p in flight.list_bundles(str(tmp_path))
                if p.endswith("_stall.json")]) == 1
