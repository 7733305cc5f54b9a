"""The port's fused linear + softmax cross-entropy (deeplearning4j_tpu_torch/
ops/xent_kernel.py, the forward and backward kernels' plain versions, which
the CPU runs) against the JAX package's Pallas kernels `_fwd_kernel` /
`_bwd_kernel`, run as tests/test_xent_kernel.py runs them on the CPU
(interpret mode, `xk.plan(64, 128, 2048, ...)`), and the output layer's
loss routing.

Inputs are made with numpy from a seed, as tests/test_xent_kernel.py makes
them: one-hot labels (the JAX backward's index path), soft labels (its
dense path) and one smoothed row among one-hot ones (which must take the
dense path). Tolerances are the JAX test's: values 1e-4 absolute + 1e-5
relative, gradients 2e-4 absolute + 1e-4 relative (float32, sums over d and
the vocabulary in another order); bfloat16 x and W 5e-2 absolute + 2e-2
relative on values against the JAX reference formulation.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.ops import xent_kernel as xk
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.nn.layers.base import Layer as TLayer
from deeplearning4j_tpu_torch.ops import xent_kernel as txk

N, D, V = 64, 128, 2048


def _inputs(seed, labels="onehot", n=N, d=D, v=V):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((v,)) * 0.1).astype(np.float32)
    if labels == "soft":
        t = (rng.random((n, v)) * 0.01).astype(np.float32)
    else:
        t = np.eye(v, dtype=np.float32)[rng.integers(0, v, n)]
        if labels == "mixed":
            t[3] = 0.9 * t[3] + 0.1 / v
    return x, w, b, t


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_rows(x, w, b, t):
    p = xk.plan(x.shape[0], x.shape[1], w.shape[1], x.dtype)
    return xk.linear_xent_rows(x, w, b, t, p, True)


@pytest.mark.parametrize("labels", ["onehot", "soft", "mixed"])
def test_rows_match_pallas_interpret(labels):
    x, w, b, t = _inputs(1, labels)
    want = _jax_rows(*(jnp.asarray(a) for a in (x, w, b, t)))
    got = txk.linear_xent_rows(_t(x), _t(w), _t(b), _t(t))
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("labels", ["onehot", "soft", "mixed"])
def test_gradients_match_pallas_interpret(labels):
    """A weighted row sum makes every per-row cotangent distinct, as the
    JAX test does; one-hot takes the JAX index backward, soft and mixed the
    dense one."""
    x, w, b, t = _inputs(2, labels)
    wt = np.arange(N, dtype=np.float32) / N
    jt, jwt = jnp.asarray(t), jnp.asarray(wt)
    want = jax.grad(lambda *a: jnp.sum(_jax_rows(*a, jt) * jwt),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, w, b)))
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    (txk.linear_xent_rows(*leaves, _t(t)) * _t(wt)).sum().backward()
    for name, a, e in zip(("x", "W", "b"), leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(e), atol=2e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("labels", ["onehot", "soft", "mixed"])
def test_forward_side_outputs_match_pallas(labels):
    """lse, T, the argmax and the one-hot flag the backward reads, against
    the JAX forward kernel's residuals (argmax compared on one-hot rows,
    the only rows whose index the backward uses)."""
    x, w, b, t = _inputs(3, labels)
    fwd_blocks = xk.plan(N, D, V, jnp.float32)[0]
    jrow, jlse, jts, jidx, joh = xk._fwd(
        *(jnp.asarray(a) for a in (x, w, b.reshape(1, -1), t)),
        *fwd_blocks, True)
    row, lse, ts, idx, oh = txk.linear_xent_fwd(_t(x), _t(w), _t(b), _t(t))
    for got, want in ((row, jrow), (lse, jlse), (ts, jts)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                                   atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(joh)[:, 0])
    one = oh.numpy() > 0.5
    assert one.all() == (labels == "onehot")
    np.testing.assert_array_equal(idx.numpy()[one],
                                  np.asarray(jidx)[:, 0][one])


def test_backward_outputs_match_pallas_dense_and_index_paths():
    """dx, the dz spill and db of the plain backward against the JAX
    `_bwd` pallas_call on both paths (index: one-hot labels rebuilt from
    idx; dense: the labels read)."""
    x, w, b, t = _inputs(4, "onehot")
    g = np.linspace(0.5, 1.5, N, dtype=np.float32)
    _, (bni, bvi), (bnd, bvd) = xk.plan(N, D, V, jnp.float32)
    row, lse, ts, idx, oh = txk.linear_xent_fwd(_t(x), _t(w), _t(b), _t(t))
    got = txk.linear_xent_bwd(_t(x), _t(w), _t(b), _t(t), idx,
                              oh.amin().reshape(()), lse, ts, _t(g))
    jx, jw, jb2 = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b[None])
    res = [jnp.asarray(a.numpy()[:, None]) for a in (lse, ts)]
    jg = jnp.asarray(g[:, None])
    for use_idx, labels_or_idx, bn, bv in (
            (True, jnp.asarray(idx.numpy()[:, None]), bni, bvi),
            (False, jnp.asarray(t), bnd, bvd)):
        dx, dw, db = xk._bwd(jx, jw, jb2, labels_or_idx, *res, jg, bn, bv,
                             True, use_idx)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(dx),
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(db)[0],
                                   atol=2e-4, rtol=1e-4)
        dw_port = (_t(x).T @ got[1]).numpy()
        np.testing.assert_allclose(dw_port, np.asarray(dw), atol=2e-4,
                                   rtol=1e-4)


def test_bfloat16_within_tolerance():
    x, w, b, t = _inputs(5)
    xb, wb = (a.astype(ml_dtypes.bfloat16) for a in (x, w))
    want = xk.linear_xent_reference(jnp.asarray(xb), jnp.asarray(wb),
                                    jnp.asarray(b), jnp.asarray(t))
    got = txk.linear_xent_rows(_t(xb).bfloat16(), _t(wb).bfloat16(), _t(b),
                               _t(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2,
                               rtol=2e-2)


def test_bfloat16_gradients_keep_dtypes():
    """Under the mixed path the dz spill, dx and dW are bfloat16 and db
    float32, as in the JAX package."""
    x, w, b, t = _inputs(6, n=16, d=32, v=40)
    leaves = [_t(x).bfloat16().requires_grad_(),
              _t(w).bfloat16().requires_grad_(), _t(b).requires_grad_()]
    txk.linear_xent_rows(*leaves, _t(t)).sum().backward()
    assert [a.grad.dtype for a in leaves] == [torch.bfloat16,
                                              torch.bfloat16, torch.float32]
    dz = txk.linear_xent_bwd(
        leaves[0].detach(), leaves[1].detach(), _t(b), _t(t),
        torch.zeros(16, dtype=torch.int32), torch.zeros(()),
        torch.zeros(16), torch.ones(16), torch.ones(16))[1]
    assert dz.dtype == torch.bfloat16


def test_ragged_shapes_match_the_reference_formulation():
    """Shapes the JAX planner refuses (n = 7, d = 5, v = 11) go through the
    port's path, which takes any size."""
    x, w, b, t = _inputs(7, "mixed", n=7, d=5, v=11)
    assert xk.plan(7, 5, 11, jnp.float32) is None
    want = xk.linear_xent_reference(*(jnp.asarray(a) for a in (x, w, b, t)))
    got = txk.linear_xent_rows(_t(x), _t(w), _t(b), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_integer_labels_are_data():
    x, w, b, t = _inputs(8, n=8, d=16, v=24)
    xt = _t(x).requires_grad_()
    txk.linear_xent_rows(xt, _t(w), _t(b),
                         torch.from_numpy(t.astype(np.int32))).sum().backward()
    xr = _t(x).requires_grad_()
    txk.linear_xent_reference(xr, _t(w), _t(b), _t(t)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), atol=1e-6)


def test_launches_stay_zero_on_cpu():
    before = (txk.linear_xent_fwd.launches, txk.linear_xent_bwd.launches)
    x, w, b, t = _inputs(9, n=8, d=16, v=24)
    xt = _t(x).requires_grad_()
    txk.linear_xent_rows(xt, _t(w), _t(b), _t(t)).sum().backward()
    assert (txk.linear_xent_fwd.launches,
            txk.linear_xent_bwd.launches) == before


@pytest.mark.parametrize("bad", ["w_shape", "labels_shape", "w_dtype",
                                 "rank"])
def test_refuses_what_it_does_not_take(bad):
    x, w, b, t = (_t(a) for a in _inputs(10, n=8, d=16, v=24))
    if bad == "w_shape":
        w = w[:8]
    elif bad == "labels_shape":
        t = t[:, :5]
    elif bad == "w_dtype":
        w = w.double()
    else:
        x = x[None]
    with pytest.raises(ValueError):
        txk.linear_xent_fwd(x, w, b, t)


# ----------------------------------------------------- the output layer
def _layer_pair(layer_cls, n_out, **kw):
    jl = layer_cls(n_out=n_out, **kw)
    return jl, TLayer.from_json(jl.to_json())


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_output_loss_takes_the_fused_route_like_jax(masked, monkeypatch):
    """RnnOutput(mcxent, softmax) computes its loss through
    linear_xent_rows in the port; the JAX layer's builtin path (no plan at
    this vocabulary) gives the same score and per-example values, with a
    labels mask whose second row is masked entirely."""
    jl, tl = _layer_pair(jlayers.RnnOutput, 40, loss="mcxent",
                         activation="softmax")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 12)).astype(np.float32)
    y = np.eye(40, dtype=np.float32)[rng.integers(0, 40, (2, 6))]
    m = None
    if masked:
        m = np.ones((2, 6), np.float32)
        m[0, 4:] = 0
        m[1] = 0
    from deeplearning4j_tpu.nn import inputs as jit_

    jp = jl.init_params(jax.random.PRNGKey(0), jit_.recurrent(12, 6))
    params = jax.tree_util.tree_map(np.asarray, jp)
    js, jper, _ = jl.compute_loss(jp, jnp.asarray(x), jnp.asarray(y),
                                  state={}, mask=None if m is None
                                  else jnp.asarray(m))
    calls = []
    real = txk.linear_xent_rows
    monkeypatch.setattr(txk, "linear_xent_rows",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tp = interop.layer_params_from_jax(tl, params)
    ts, tper, _ = tl.compute_loss(tp, torch.from_numpy(x),
                                  torch.from_numpy(y), state={},
                                  mask=None if m is None
                                  else torch.from_numpy(m))
    assert calls == [(12, 12)]
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), atol=1e-5)


@pytest.mark.parametrize("loss,act", [("mse", "identity"),
                                      ("mcxent", "sigmoid")])
def test_other_losses_take_the_plain_route(loss, act, monkeypatch):
    jl, tl = _layer_pair(jlayers.Output, 5, loss=loss, activation=act)
    monkeypatch.setattr(txk, "linear_xent_rows",
                        lambda *a: pytest.fail("fused route taken"))
    from deeplearning4j_tpu.nn import inputs as jit_

    jp = jl.init_params(jax.random.PRNGKey(1), jit_.feed_forward(7))
    x = np.random.default_rng(1).standard_normal((4, 7)).astype(np.float32)
    y = np.random.default_rng(2).random((4, 5)).astype(np.float32)
    js, _, _ = jl.compute_loss(jp, jnp.asarray(x), jnp.asarray(y), state={})
    tp = interop.layer_params_from_jax(
        tl, jax.tree_util.tree_map(np.asarray, jp))
    ts, _, _ = tl.compute_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                               state={})
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)


def test_fused_route_under_mixed_precision_matches_jax_builtin():
    jl, tl = _layer_pair(jlayers.RnnOutput, 30, loss="mcxent",
                         activation="softmax")
    from deeplearning4j_tpu.nn import inputs as jit_
    from deeplearning4j_tpu import dtypes as jdtypes

    jp = jl.init_params(jax.random.PRNGKey(2), jit_.recurrent(16, 5))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    y = np.eye(30, dtype=np.float32)[rng.integers(0, 30, (2, 5))]
    tp = interop.layer_params_from_jax(
        tl, jax.tree_util.tree_map(np.asarray, jp))
    with jdtypes.mixed(), tdtypes.mixed():
        js, _, _ = jl.compute_loss(jp, jnp.asarray(x), jnp.asarray(y),
                                   state={})
        ts, _, _ = tl.compute_loss(tp, torch.from_numpy(x),
                                   torch.from_numpy(y), state={})
    assert ts.dtype == torch.float32
    np.testing.assert_allclose(float(ts), float(js), rtol=2e-2)
