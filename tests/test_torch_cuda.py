"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on a CUDA device, including the paths the served shapes do
not reach (bn_act: ragged row counts, channel counts that are not a
multiple of the vector width, unaligned views; flash_attention: ragged t,
t = 1, non-causal, every head dim, the lse output), and the attention
layer's routing to the kernel.

Marked `cuda`; they skip where torch.cuda.is_available() is False. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bn_act, 1 ulp of the dtype at the magnitude of the
multiply-add's terms (the kernel matches the plain version's rounding, so
the error is 0 in practice); flash_attention, 1e-5 (float32) or 2e-2
(bfloat16) of the plain output's largest magnitude (sums in another order,
P rounded at another running max), lse 1e-5 of its largest magnitude.
"""
import pytest
import torch

from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
from deeplearning4j_tpu_torch.ops.bn_act import bn_act, bn_act_reference
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

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
