"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on a CUDA device, including the paths the ResNet-50 shapes
do not reach (ragged row counts, channel counts that are not a multiple of
the vector width, unaligned views).

Marked `cuda`; they skip where torch.cuda.is_available() is False. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1 ulp of the dtype at the magnitude of the multiply-add's terms
(the kernel matches the plain version's rounding, so the error is 0 in
practice).
"""
import pytest
import torch

from deeplearning4j_tpu_torch.ops.bn_act import bn_act, bn_act_reference

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
