"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on a CUDA device, including the paths the served shapes do
not reach (bn_act: ragged row counts, channel counts that are not a
multiple of the vector width, unaligned views; flash_attention: ragged t,
t = 1, non-causal, every head dim, the lse output; lstm_scan: masks with a
fully masked row, ragged b and n, long t, n past the shared-memory resident
width, the cap on n), the attention layer's routing to the kernel, and
`rnn_time_step` on the card against `output`.

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
probabilities with TF32 off.
"""
import pytest
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
from deeplearning4j_tpu_torch.ops.bn_act import bn_act, bn_act_reference
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from deeplearning4j_tpu_torch.ops.lstm import (
    MAX_N,
    lstm_scan,
    lstm_scan_peephole,
    lstm_scan_reference,
)
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

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
