"""A plain-PyTorch rehearsal of the arithmetic the card's flash-attention
forward kernel (deeplearning4j_tpu_torch/csrc/flash_attention.cu) runs on
the tensor cores, held against the port's plain version
(`flash_attention_reference`) at the card checks' tolerances and against
the JAX package's Pallas kernel `_flash_fwd_kernel` run as the JAX tests
run it on the CPU (interpret mode), so that a change of the kernel's
numerics is tried here before it is tried on the card.

The rehearsal: q scaled in its own dtype; keys in passes of the kernel's
width (64, or 32 for float32 at d = 64); per pass S = Q . K^T in float32,
causal keys after the query set to -1e30, the online softmax from m =
-1e30 and l = 0 with a rescale of l and the accumulator per pass, l
summing the unrounded p; P rounded to v's dtype, then acc += P . V; o =
acc / max(l, 1e-37) in q's dtype, lse = m + log(max(l, 1e-37)). float32
products run as 3xTF32: each operand split into a TF32 part and the rest,
both rounded to nearest, the three products of each 8-deep step summed
apart and added to the float32 sum. bfloat16 products take q, k, v and the
once-rounded P as they are, with float32 sums (the kernel's bfloat16 exp,
by ex2.approx, is within about 2^-21 of the exp taken here).

Tolerances, as `chip_smoke.py` and tests/test_torch_cuda.py hold the
kernel: o within 1e-5 (float32) or 2e-2 (bfloat16) of the plain output's
largest magnitude (sums in another order; P rounded at another running
max), lse within 1e-5 x max(1, max|lse|). Inputs are made with numpy from a
seed and handed to both packages.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_bwd import _matmul_3xtf32, _tf32_parts

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
CARD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(DTYPES[dtype][0])
            for _ in range(3)]


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _pass_width(dtype, d):
    """Keys per pass of the kernel (its Shape::kCols)."""
    if dtype == torch.bfloat16 or d < 64:
        return 64
    return 32 if d == 64 else 16


def _fwd_card_numerics(q, k, v, causal, parts=_tf32_parts):
    """(o, lse) as the card kernel computes them (see above); `parts`
    splits a float32 operand into its TF32 parts."""
    f32 = q.dtype == torch.float32
    t, d = q.shape[-2:]
    scale = fa.scale_in(q.dtype, fa.default_scale(d))
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    kf, vf = k.float(), v.float()

    def mm(a, b):
        return _matmul_3xtf32(a, b, parts) if f32 else a @ b

    m = torch.full((*q.shape[:-1], 1), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    rows = torch.arange(t)[:, None]
    width = _pass_width(q.dtype, d)
    for k0 in range(0, t, width):
        keys = slice(k0, min(k0 + width, t))
        s = mm(qs, kf[..., keys, :].transpose(-1, -2))
        if causal:
            s = s.masked_fill(torch.arange(k0, keys.stop)[None, :] > rows,
                              fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm(p.to(v.dtype).float(), vf[..., keys, :])
        m = m_new
    l = l.clamp_min(1e-37)
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _misses(got, want, dtype):
    """(o's error over its tolerance, lse's error over its tolerance)."""
    o_err = float((got[0].float() - want[0].float()).abs().max())
    o_tol = CARD_TOL[dtype] * float(want[0].float().abs().max())
    lse_err = float((got[1] - want[1]).abs().max())
    lse_tol = 1e-5 * max(1.0, float(want[1].abs().max()))
    return o_err / o_tol, lse_err / lse_tol


def _card_case(dtype, shape, causal, parts=_tf32_parts):
    q, k, v = (_t(a, dtype) for a in _qkv(shape, dtype, seed=11))
    got = _fwd_card_numerics(q, k, v, causal, parts)
    want = fa.flash_attention_reference(q, k, v, causal, return_lse=True)
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    return _misses(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 128, 64),    # refer-train's heads
                                   (1, 2, 512, 64)])   # the served length
def test_card_numerics_hold_the_card_tolerances(dtype, causal, shape):
    o_miss, lse_miss = _card_case(dtype, shape, causal)
    assert o_miss <= 1.0 and lse_miss <= 1.0, (o_miss, lse_miss)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(64, 16), (128, 64), (64, 128)])
def test_card_numerics_match_pallas_interpret(dtype, causal, t, d):
    q, k, v = _qkv((1, 2, t, d), dtype, seed=t + d)
    want = pk._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                         causal=causal, scale=d ** -0.5, bq=32, bk=32,
                         interpret=True, return_lse=True)
    want = tuple(torch.tensor(np.asarray(a, np.float32)) for a in want)
    got = _fwd_card_numerics(*(_t(a, dtype) for a in (q, k, v)), causal)
    o_miss, lse_miss = _misses(got, want, dtype)
    assert o_miss <= 1.0 and lse_miss <= 1.0, (o_miss, lse_miss)


def test_one_tf32_product_per_step_would_not_hold_float32():
    """The rehearsal can fail: with the lo parts dropped (one TF32 product
    per step) o misses its 1e-5 and lse its 1e-5."""
    o_miss, lse_miss = _card_case(
        "float32", (2, 8, 128, 64), True,
        lambda x: (_tf32_parts(x)[0], torch.zeros_like(x)))
    assert o_miss > 1.0 and lse_miss > 1.0, (o_miss, lse_miss)
