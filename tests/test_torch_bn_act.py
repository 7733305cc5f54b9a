"""The port's bn_act (deeplearning4j_tpu_torch/ops/bn_act.py) against the JAX
package's Pallas kernel, run as the JAX tests run it on the CPU (interpret
mode) and through its plain reference.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: float32 agrees to float rounding (rtol 1e-6, the JAX tests'
own bound for the kernel); bfloat16 to 1 ulp of bfloat16 at the magnitude
of the multiply-add's terms (|x*scale| + |shift|), since each program may
round the product once or not at all before the add.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import bn_act as tbn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = {"float32": (np.float32, torch.float32, 2.0 ** -23),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2.0 ** -7)}


def _inputs(c, dtype, shape=(2, 4, 4)):
    rng = np.random.default_rng(1000 + c)
    x = rng.standard_normal(shape + (c,)).astype(DTYPES[dtype][0])
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, shift


def _to_torch(x, dtype):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.to(DTYPES[dtype][1])


def _assert_close(got, want, x, scale, shift, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    mag = np.abs(np.asarray(x, np.float32) * scale) + np.abs(shift)
    assert (np.abs(got - want) <= DTYPES[dtype][2] * mag + 1e-30).all()


CASES = [(act, dtype, c) for act in ("relu", "identity")
         for dtype in DTYPES for c in (8, 64, 256)]


@pytest.mark.parametrize("act,dtype,c", CASES)
def test_reference_matches_jax_reference(act, dtype, c):
    x, scale, shift = _inputs(c, dtype)
    want = pk.bn_act_reference(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(shift), act)
    got = tbn.bn_act_reference(_to_torch(x, dtype), torch.from_numpy(scale),
                               torch.from_numpy(shift), act)
    assert got.dtype == DTYPES[dtype][1]
    _assert_close(got, want, x, scale, shift, dtype)


@pytest.mark.parametrize("act,dtype,c", CASES)
def test_cpu_bn_act_matches_pallas_interpret(act, dtype, c):
    x, scale, shift = _inputs(c, dtype)
    br = pk.pick_bn_block(x.shape, x.dtype)
    assert br > 0
    want = pk.bn_act(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift),
                     act, br, True)
    got = tbn.bn_act(_to_torch(x, dtype), torch.from_numpy(scale),
                     torch.from_numpy(shift), act)
    _assert_close(got, want, x, scale, shift, dtype)


def test_launches_stay_zero_on_cpu():
    before = tbn.bn_act.launches
    x, scale, shift = _inputs(64, "float32")
    tbn.bn_act(torch.from_numpy(x), torch.from_numpy(scale),
               torch.from_numpy(shift), "relu")
    assert tbn.bn_act.launches == before


def test_non_contiguous_input_raises():
    x, scale, shift = _inputs(8, "float32")
    xt = torch.from_numpy(x).transpose(1, 2)  # strided view, same shape
    assert not xt.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tbn.bn_act(xt, torch.from_numpy(scale), torch.from_numpy(shift))


@pytest.mark.parametrize("bad", ["scale_shape", "shift_shape", "act"])
def test_bad_arguments_raise(bad):
    x, scale, shift = _inputs(8, "float32")
    xt, s, h = (torch.from_numpy(x), torch.from_numpy(scale),
                torch.from_numpy(shift))
    act = "relu"
    if bad == "scale_shape":
        s = s[:4]
    elif bad == "shift_shape":
        h = torch.zeros(9)
    else:
        act = "tanh"
    with pytest.raises(ValueError):
        tbn.bn_act(xt, s, h, act)


def test_gradients_match_jax():
    """The backward recomputes through the plain epilogue, as the JAX
    custom VJP does: gradients wrt x, scale and shift agree."""
    x, scale, shift = _inputs(8, "float32")
    br = pk.pick_bn_block(x.shape, x.dtype)

    def loss(a, s, h):
        return (pk.bn_act(a, s, h, "relu", br, True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, shift)]
    (tbn.bn_act(*ts, "relu") ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_module_imports_without_nvcc():
    """Importing the kernel module (and the whole layer stack) needs no
    CUDA compiler; asking for the build without one raises a typed error."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               PYTHONPATH=REPO)
    code = ("import deeplearning4j_tpu_torch.ops.bn_act as m\n"
            "import deeplearning4j_tpu_torch.nn.layers\n"
            "from deeplearning4j_tpu_torch.ops import _build\n"
            "try:\n"
            "    _build.nvcc_path()\n"
            "except _build.KernelBuildError:\n"
            "    print('no-nvcc', m.bn_act.launches)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no-nvcc 0"


def test_gradient_wrt_x_alone_matches_plain_version():
    """Only x requires grad (inference-frozen BN params): the recompute
    backward returns no gradient for scale/shift and the plain one for x."""
    x, scale, shift = _inputs(64, "float32")
    xt = torch.from_numpy(x).requires_grad_()
    s, h = torch.from_numpy(scale), torch.from_numpy(shift)
    (tbn.bn_act(xt, s, h, "relu") ** 2).sum().backward()
    xr = torch.from_numpy(x).requires_grad_()
    (tbn.bn_act_reference(xr, s, h, "relu") ** 2).sum().backward()
    assert s.grad is None and h.grad is None
    assert torch.equal(xt.grad, xr.grad)
