"""The port's flash-attention backward (deeplearning4j_tpu_torch/ops/
flash_attention.py: the dq and dk/dv kernels' plain formulas, which the CPU
runs) against the JAX package's Pallas pair `_flash_bwd_dq_kernel` /
`_flash_bwd_dkv_kernel`, run as the JAX tests run them on the CPU
(interpret mode, blocks bq = bk = 16).

Inputs (q, k, v and the output cotangent dO) are made with numpy from a seed
and handed to both packages. Tolerances, relative to the largest magnitude
of the expected gradient:
  - through autograd (jax.vjp of pk.flash_attention against loss.backward
    of the port's flash_attention): float32 1e-5 (sums in another order;
    the Pallas forward's online softmax against the plain version's whole
    row feeds o and lse to the backward), bfloat16 2e-2 (o rounded to
    bfloat16 at another running max in each program, which moves delta);
  - the backward formulas alone, on the same o and lse: float32 1e-5,
    bfloat16 1e-2 (one bfloat16 rounding of the result apart).

A plain-PyTorch rehearsal of the card kernels' arithmetic (3xTF32 for
float32, bfloat16 pairs for P and dS) is held against the plain formulas
at the card checks' tolerances, so that a change of numerics is tried here
before it is tried on the card.
"""
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import flash_attention as fa

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
TOL_GRAD = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_FORMULA = {"float32": 1e-5, "bfloat16": 1e-2}


def _arrays(shape, dtype, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(DTYPES[dtype][0])
            for _ in range(n)]


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_grads(q, k, v, do, causal):
    def f(q_, k_, v_):
        return pk.flash_attention(q_, k_, v_, causal, None, 16, 16, True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(16, 16), (32, 16), (32, 64), (64, 32)])
def test_autograd_matches_pallas_interpret(dtype, causal, t, d):
    q, k, v, do = _arrays((2, 3, t, d), dtype, seed=t * 7 + d)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv = (_t(a, dtype).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal)
    o.backward(_t(do, dtype))
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == DTYPES[dtype][1], name
        assert _rel(got, np.asarray(w, np.float32)) < TOL_GRAD[dtype], (
            name, _rel(got, np.asarray(w, np.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_formulas_match_pallas_on_the_same_residuals(dtype, causal):
    """The dq and dk/dv wrappers (CPU: the plain formulas) against
    `pk._flash_bwd` given the same o and lse, so only the backward's own
    arithmetic is compared; dq's single factor of scale and dk's pre-scaled
    q included (d = 32: the scale is not a bfloat16 number)."""
    q, k, v, do = _arrays((2, 2, 32, 32), dtype, seed=5)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = pk._flash_fwd(jq, jk, jv, causal=causal, scale=32 ** -0.5,
                           bq=16, bk=16, interpret=True, return_lse=True)
    want = pk._flash_bwd(jq, jk, jv, o, lse, jdo, causal=causal,
                         scale=32 ** -0.5, bq=16, bk=16, interpret=True)
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    to = _t(np.asarray(o, np.float32), dtype)
    tlse = torch.from_numpy(np.asarray(lse, np.float32))
    delta = (tdo.float() * to.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(tq, tk, tv, tdo, tlse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tdo, tlse, delta, causal)
    ref = fa.flash_attention_bwd_reference(tq, tk, tv, to, tlse, tdo, causal)
    for name, got, r, w in zip("qkv", (dq, dk, dv), ref, want):
        w = np.asarray(w, np.float32)
        assert _rel(got, w) < TOL_FORMULA[dtype], (name, _rel(got, w))
        assert torch.equal(got, r), name


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_t_matches_autograd_of_the_plain_forward(causal):
    """t = 13 (no multiple of any tile): the JAX layer sends such lengths
    to sdpa, so the port's backward is held against autograd through its
    own plain forward, which differentiates the same function."""
    q, k, v, do = _arrays((2, 3, 13, 16), "float32", seed=13)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        tq, tk, tv = (_t(a, "float32").requires_grad_() for a in (q, k, v))
        fn(tq, tk, tv, causal).backward(_t(do, "float32"))
        grads.append((tq.grad, tk.grad, tv.grad))
    for got, want in zip(*grads):
        assert _rel(got, want.numpy()) < 1e-5


def test_lse_output_is_not_differentiable_and_o_still_is():
    q, k, v, do = _arrays((1, 2, 16, 16), "float32", seed=3)
    tq, tk, tv = (_t(a, "float32").requires_grad_() for a in (q, k, v))
    o, lse = fa.flash_attention(tq, tk, tv, True, return_lse=True)
    assert o.requires_grad and not lse.requires_grad
    o.backward(_t(do, "float32"))
    want = _jax_grads(q, k, v, do, True)
    assert _rel(tq.grad, np.asarray(want[0])) < 1e-5


def test_backward_launches_stay_zero_on_cpu():
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    q, k, v, do = _arrays((1, 2, 16, 16), "float32", seed=4)
    tq = _t(q, "float32").requires_grad_()
    fa.flash_attention(tq, _t(k, "float32"), _t(v, "float32")).backward(
        _t(do, "float32"))
    assert tq.grad is not None
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "lse_dtype",
                                 "delta_shape", "do_transposed"])
def test_backward_wrappers_refuse_what_they_do_not_take(bad):
    q, k, v, do = (_t(a, "float32")
                   for a in _arrays((1, 2, 8, 16), "float32", seed=1))
    lse = torch.zeros(1, 2, 8)
    delta = torch.zeros(1, 2, 8)
    if bad == "do_shape":
        do = do[:, :, :4]
    elif bad == "do_dtype":
        do = do.double()
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "delta_shape":
        delta = delta[..., :4]
    else:
        do = _t(_arrays((1, 8, 2, 16), "float32", seed=2)[0],
                "float32").transpose(1, 2)
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError):
            fn(q, k, v, do, lse, delta)


# ------------------------------------------------ the card kernels' numerics
# A plain-PyTorch rehearsal of the arithmetic csrc/flash_attention_bwd.cu
# runs on the tensor cores, held against `_bwd_plain` at the card checks'
# tolerances (float32 1e-4, bfloat16 1e-2, each output against its own
# largest magnitude). float32: every product as 3xTF32, each operand split
# into a TF32 part and the rest, both rounded to nearest, the three
# products of each 8-deep step summed apart and added to a float32
# accumulator. bfloat16: q, k, v and dO enter as they are, P and dS as a
# bfloat16 pair hi + lo (two products).
def _tf32_parts(x):
    """(hi, lo) of float32 `x`: hi its bits rounded to nearest at the 13th
    bit from the bottom, lo = x - hi rounded the same way (split_tf32)."""
    def rnd(a):
        bits = a.contiguous().numpy().view(np.uint32)
        return torch.from_numpy(((bits + np.uint32(0x1000))
                                 & np.uint32(0xffffe000)).view(np.float32))
    hi = rnd(x)
    return hi, rnd(x - hi)


def _matmul_3xtf32(a, b, parts=_tf32_parts):
    """a @ b over the last axes, 8-deep steps of three TF32 products each,
    every step's sum added to the float32 accumulator in order."""
    (ah, al), (bh, bl) = parts(a), parts(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        acc = acc + (al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :]
                     + ah[..., s] @ bh[..., s, :])
    return acc


def _bf16_pair(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bwd_card_numerics(q, k, v, do, lse, delta, causal, scale,
                       parts=_tf32_parts):
    """dq, dk, dv as the card kernels compute them (see above); `parts`
    splits a float32 operand into its TF32 parts."""
    f32 = q.dtype == torch.float32
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))

    def mm(a, b):
        return _matmul_3xtf32(a, b, parts) if f32 else a @ b

    p = torch.exp(mm(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    if causal:
        t = p.shape[-1]
        p = p.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), 0.0)
    ds = p * (mm(dof, vf.transpose(-1, -2)) - delta[..., None])
    if f32:
        dq = mm(ds, kf) * scale
        dk = mm(ds.transpose(-1, -2), qf) * scale
        dv = mm(p.transpose(-1, -2), dof)
    else:
        (dsh, dsl), (ph, pl) = _bf16_pair(ds), _bf16_pair(p)
        dq = (dsh @ kf + dsl @ kf) * scale
        dk = (dsh.transpose(-1, -2) @ qf + dsl.transpose(-1, -2) @ qf) * scale
        dv = ph.transpose(-1, -2) @ dof + pl.transpose(-1, -2) @ dof
    return tuple(a.to(q.dtype) for a in (dq, dk, dv))


CARD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _card_case(dtype, shape, parts=_tf32_parts):
    """(the rehearsal's, the plain) dq, dk, dv at `shape`, causal."""
    q, k, v, do = (_t(a, dtype) for a in _arrays(shape, dtype, seed=11))
    o, lse = fa.flash_attention_reference(q, k, v, True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    scale = shape[-1] ** -0.5
    got = _bwd_card_numerics(q, k, v, do, lse, delta, True, scale, parts)
    want = (fa._bwd_plain(q, k, v, do, lse, delta, True, scale, "dq"),
            *fa._bwd_plain(q, k, v, do, lse, delta, True, scale, "dkv"))
    return got, want


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 8, 128, 64),    # refer-train's heads
                                   (1, 2, 512, 64)])   # the training length
def test_card_numerics_hold_the_card_tolerances(dtype, shape):
    for name, a, r in zip("qkv", *_card_case(dtype, shape)):
        assert a.dtype == r.dtype
        assert _rel(a, r.float().numpy()) <= CARD_TOL[dtype], (
            name, _rel(a, r.float().numpy()))


def test_one_tf32_product_per_step_would_not_hold_float32():
    """The rehearsal can fail: with the lo parts dropped (one TF32 product
    per step) every gradient misses 1e-4 (by about 5x)."""
    got, want = _card_case("float32", (2, 8, 128, 64),
                           lambda x: (_tf32_parts(x)[0], torch.zeros_like(x)))
    for name, a, r in zip("qkv", got, want):
        assert _rel(a, r.float().numpy()) > CARD_TOL["float32"], name


def test_library_name_follows_the_headers_a_source_includes(tmp_path,
                                                             monkeypatch):
    """An edited csrc header rebuilds every library whose source includes
    it, directly or through another header, and only those: the flash
    kernels' tile header renames both flash libraries, the mma header
    (which the tile header includes) those and linear_xent's."""
    from deeplearning4j_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    names = ("flash_attention", "flash_attention_bwd", "linear_xent",
             "bn_act")
    renamed = {"flash_tiles.cuh": {"flash_attention", "flash_attention_bwd"},
               "hopper_mma.cuh": {"flash_attention", "flash_attention_bwd",
                                  "linear_xent"}}
    for name, want in renamed.items():
        before = {n: _build.library_path(n) for n in names}
        header = csrc / name
        header.write_text(header.read_text() + "// edited\n")
        after = {n: _build.library_path(n) for n in names}
        assert {n for n in names if after[n] != before[n]} == want, name
