"""The convolution family's breadth (Conv1D, Deconv2D, SeparableConv2D,
Subsampling1D, sum and pnorm in Subsampling2D, Upsampling1D/2D,
ZeroPadding1D/2D), ElementWiseMultiplication and CenterLossOutput in the
port, against the JAX package.

Each layer is built by the JAX package and read by the port from its JSON;
the JAX layer's weights (biases drawn nonzero) are carried across with
`interop.layer_params_from_jax`, and both take the same numpy input made
from a seed. Tolerances: outputs and the gradients of sum(out * w), w
seeded, with respect to the input and every param, 1e-5 of each one's
largest magnitude (float32 sums in another order); NaN exactly where JAX
has NaN. Networks: the config JSON equal, per-step scores 1e-5 relative,
params 1e-5 absolute, running state (CenterLossOutput's centers) 1e-5
absolute.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models import serialization as jser
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import MultiLayerNetwork, restore_model
from deeplearning4j_tpu_torch.models import serialization as tser
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _params(jlayer, in_type, rng):
    """The JAX layer's params as numpy, biases drawn nonzero."""
    p = {k: np.asarray(v) for k, v in
         jlayer.init_params(jax.random.PRNGKey(3), in_type).items()}
    if "b" in p:
        p["b"] = (rng.standard_normal(p["b"].shape) * 0.3).astype(np.float32)
    return p


def _forward_and_grads(jlayer, in_type, x, seed=0):
    """(JAX, port) pairs of (output, input gradient, {param: gradient in
    the interchange layout}) of sum(out * w)."""
    rng = np.random.default_rng(seed)
    tlayer = Layer.from_json(json.loads(json.dumps(jlayer.to_json())))
    assert json.dumps(tlayer.to_json()) == json.dumps(jlayer.to_json())
    assert type(tlayer).__name__ == type(jlayer).__name__
    params = _params(jlayer, in_type, rng)

    def jfn(p, xx):
        return jlayer.apply(p, xx, state={}, train=False, rng=None)[0]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jout = np.asarray(jfn(jp, jnp.asarray(x)))
    w = rng.standard_normal(jout.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx) * w),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in
          interop.layer_params_from_jax(tlayer, params).items()}
    tx = torch.tensor(x, requires_grad=True)
    tout, _ = tlayer.apply(tp, tx, state={}, train=False)
    (tout * torch.from_numpy(w)).sum().backward()
    tgp = {k: tlayer.to_interchange(k, v.grad).numpy() for k, v in tp.items()}
    return ((jout, np.asarray(jgx), {k: np.asarray(v) for k, v in jgp.items()}),
            (tout.detach().numpy(), tx.grad.numpy(), tgp))


def _assert_matches(jlayer, in_type, x, tol=1e-5):
    (jo, jgx, jgp), (to, tgx, tgp) = _forward_and_grads(jlayer, in_type, x)
    assert _rel(to, jo) <= tol
    assert _rel(tgx, jgx) <= tol
    assert sorted(tgp) == sorted(jgp)
    for k in jgp:
        assert _rel(tgp[k], jgp[k]) <= tol, k
    return jo, to


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- Deconv2D
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("mode", ["truncate", "same"])
def test_deconv2d_matches_jax(mode, k, stride, pad):
    """Both modes, k in {2, 3, 4}, stride in {1, 2}, pad in {0, 1}: lax's
    conv_transpose (no kernel flip; explicit pads on the dilated input)
    reproduced through cuDNN's transposed conv."""
    layer = jl.Deconv2D(kernel_size=(k, k), stride=(stride, stride),
                        padding=(pad, pad), n_out=5, convolution_mode=mode,
                        activation="tanh")
    in_type = jit.convolutional(5, 6, 3)
    jo, to = _assert_matches(layer, in_type, _x((2, 5, 6, 3)))
    declared = Layer.from_json(layer.to_json()).output_type(in_type)
    assert declared.shape() == layer.output_type(in_type).shape()
    if mode == "same" or pad == 0:  # declared == computed (C.15 aside)
        assert to.shape[1:] == declared.shape()[1:]


def test_deconv2d_declared_shape_differs_from_computed_in_both():
    """ROADMAP C.15, pinned in both packages: k 4, stride 2, pad 1 on 5x5
    declares 10x10 and computes 8x8."""
    layer = jl.Deconv2D(kernel_size=(4, 4), stride=(2, 2), padding=(1, 1),
                        n_out=2)
    in_type = jit.convolutional(5, 5, 3)
    tlayer = Layer.from_json(layer.to_json())
    assert layer.output_type(in_type).shape() == (-1, 10, 10, 2)
    assert tlayer.output_type(in_type).shape() == (-1, 10, 10, 2)
    jo, to = _assert_matches(layer, in_type, _x((1, 5, 5, 3)))
    assert jo.shape == to.shape == (1, 8, 8, 2)


def test_deconv2d_mixed_precision_matches_jax():
    """bf16 operands under both packages' mixed policy, 2 ulp of bfloat16
    relative to the output's largest magnitude."""
    layer = jl.Deconv2D(kernel_size=(3, 3), stride=(2, 2), n_out=4,
                        convolution_mode="same")
    in_type = jit.convolutional(4, 4, 3)
    x = _x((2, 4, 4, 3))
    params = _params(layer, in_type, np.random.default_rng(0))
    tlayer = Layer.from_json(layer.to_json())
    with jdtypes.mixed(), tdtypes.mixed():
        want, _ = layer.apply({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), state={}, train=False, rng=None)
        got, _ = tlayer.apply(interop.layer_params_from_jax(tlayer, params),
                              torch.from_numpy(x), state={}, train=False)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2 ** -6


# ------------------------------------------------------ SeparableConv2D
@pytest.mark.parametrize("case", [
    dict(depth_multiplier=2, convolution_mode="same", stride=(2, 2),
         dilation=(2, 2)),
    dict(depth_multiplier=1, convolution_mode="truncate", stride=(1, 1),
         padding=(1, 1)),
    dict(depth_multiplier=3, convolution_mode="same", stride=(1, 2),
         has_bias=False),
], ids=["dm2-same-s2-d2", "dm1-truncate-p1", "dm3-same-nobias"])
def test_separable_conv2d_matches_jax(case):
    layer = jl.SeparableConv2D(kernel_size=(3, 3), n_out=5,
                               activation="relu", **case)
    _assert_matches(layer, jit.convolutional(9, 8, 3), _x((2, 9, 8, 3)))


def test_separable_conv2d_layout_and_regularizable():
    """dW and pW are held as Conv2D holds its kernel (OIHW channels_last)
    and go back to HWIO exactly; l1/l2 reach dW and pW, not b."""
    t = Layer.from_json(jl.SeparableConv2D(
        kernel_size=(3, 3), n_out=5, depth_multiplier=2).to_json())
    for key, shape, want in (("dW", (3, 3, 1, 8), (8, 1, 3, 3)),
                             ("pW", (1, 1, 8, 5), (5, 8, 1, 1))):
        hwio = torch.from_numpy(_x(shape))
        held = t.from_interchange(key, hwio)
        assert held.shape == want
        assert held.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(t.to_interchange(key, held), hwio)
    p = {"dW": torch.ones(1), "pW": torch.ones(1), "b": torch.ones(1)}
    assert sorted(t.regularizable(p)) == ["dW", "pW"]


# --------------------------------------------------------------- Conv1D
@pytest.mark.parametrize("case", [
    dict(kernel_size=3, stride=2, convolution_mode="same"),
    dict(kernel_size=4, stride=2, convolution_mode="same"),
    dict(kernel_size=3, stride=1, padding=1, dilation=2,
         convolution_mode="truncate"),
    dict(kernel_size=2, stride=3, convolution_mode="truncate"),
], ids=["k3-same-s2", "k4-same-s2", "k3-truncate-p1-d2", "k2-truncate-s3"])
def test_conv1d_matches_jax(case):
    layer = jl.Conv1D(n_out=6, activation="tanh", **case)
    in_type = jit.recurrent(4, 11)
    jo, to = _assert_matches(layer, in_type, _x((3, 11, 4)))
    assert to.shape[1] == Layer.from_json(layer.to_json()).output_type(
        in_type).timesteps


# ---------------------------------------------------------------- pools
@pytest.mark.parametrize("mode", ["truncate", "same"])
@pytest.mark.parametrize("pool", ["sum", "pnorm", "max", "avg"])
def test_subsampling2d_every_pooling_type_matches_jax(pool, mode):
    layer = jl.Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                             convolution_mode=mode, pooling_type=pool,
                             pnorm=3, padding=(1, 0))
    _assert_matches(layer, jit.convolutional(9, 8, 4), _x((2, 9, 8, 4)))


def test_subsampling2d_pnorm_zero_window_gradient_is_nan_as_in_jax():
    """A window of zeros: pnorm's value is 0 and its gradient NaN (0 **
    (1/p)) over that window's inputs, in both packages, at the same
    positions."""
    layer = jl.Subsampling2D(kernel_size=(2, 2), stride=(2, 2),
                             pooling_type="pnorm", pnorm=2)
    x = _x((1, 4, 4, 2))
    x[0, :2, :2, 0] = 0.0
    (jo, jgx, _), (to, tgx, _) = _forward_and_grads(
        layer, jit.convolutional(4, 4, 2), x)
    assert to[0, 0, 0, 0] == jo[0, 0, 0, 0] == 0.0
    assert np.isnan(jgx).any()
    np.testing.assert_array_equal(np.isnan(tgx), np.isnan(jgx))
    live = ~np.isnan(jgx)
    assert _rel(tgx[live], jgx[live]) <= 1e-5
    assert _rel(to, jo) <= 1e-5


@pytest.mark.parametrize("mode", ["truncate", "same"])
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_subsampling1d_matches_jax(pool, mode):
    """avg divides by k with pads counted, as in 2-D (ROADMAP C.5)."""
    layer = jl.Subsampling1D(kernel_size=3, stride=2, padding=1,
                             convolution_mode=mode, pooling_type=pool)
    in_type = jit.recurrent(4, 10)
    jo, to = _assert_matches(layer, in_type, _x((2, 10, 4)))
    assert to.shape[1] == Layer.from_json(layer.to_json()).output_type(
        in_type).timesteps


@pytest.mark.parametrize("layer,in_type,shape", [
    (jl.Upsampling2D(size=(2, 3)), jit.convolutional(3, 4, 2), (2, 3, 4, 2)),
    (jl.Upsampling2D(size=2), jit.convolutional(3, 4, 2), (2, 3, 4, 2)),
    (jl.Upsampling1D(size=3), jit.recurrent(2, 5), (2, 5, 2)),
    (jl.ZeroPadding2D(pad=1), jit.convolutional(3, 4, 2), (2, 3, 4, 2)),
    (jl.ZeroPadding2D(pad=(1, 2)), jit.convolutional(3, 4, 2),
     (2, 3, 4, 2)),
    (jl.ZeroPadding2D(pad=(0, 1, 2, 3)), jit.convolutional(3, 4, 2),
     (2, 3, 4, 2)),
    (jl.ZeroPadding1D(pad=2), jit.recurrent(2, 5), (2, 5, 2)),
    (jl.ZeroPadding1D(pad=(1, 3)), jit.recurrent(2, 5), (2, 5, 2)),
    (jl.ElementWiseMultiplication(n_out=6, activation="tanh"),
     jit.feed_forward(6), (4, 6)),
], ids=["up2d-pair", "up2d-int", "up1d", "zp2d-int", "zp2d-pair",
        "zp2d-four", "zp1d-int", "zp1d-pair", "elementwise"])
def test_resampling_layers_match_jax(layer, in_type, shape):
    """Every form of the padding fields (int, pair, four) through JSON, the
    declared output type equal to the computed shape."""
    if isinstance(layer, jl.ElementWiseMultiplication):
        # W starts at ones: draw it, so a misplaced W would show
        tl_ = Layer.from_json(layer.to_json())
        params = {"W": _x((6,), 5), "b": _x((6,), 6)}
        x = _x(shape)
        want = np.asarray(layer.apply(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            state={}, train=False, rng=None)[0])
        got = tl_.apply(interop.layer_params_from_jax(tl_, params),
                        torch.from_numpy(x), state={}, train=False)[0]
        assert _rel(got.numpy(), want) <= 1e-6
    jo, to = _assert_matches(layer, in_type, _x(shape))
    declared = Layer.from_json(layer.to_json()).output_type(in_type)
    assert declared.shape() == layer.output_type(in_type).shape()
    assert to.shape[1:] == tuple(declared.shape()[1:])


# ------------------------------------------------------------- networks
def _net_2d(updater):
    """Conv2D -> ZeroPadding2D -> SeparableConv2D -> Upsampling2D ->
    Deconv2D -> sum pool -> global pool -> ElementWiseMultiplication ->
    CenterLossOutput."""
    return JNNC(seed=3, updater=updater, l2=1e-3).list([
        jl.Conv2D(kernel_size=(3, 3), n_out=4, convolution_mode="same",
                  activation="relu"),
        jl.ZeroPadding2D(pad=(1, 0, 0, 1)),
        jl.SeparableConv2D(kernel_size=(3, 3), n_out=6, depth_multiplier=2,
                           convolution_mode="same", stride=(2, 2),
                           activation="tanh"),
        jl.Upsampling2D(size=(2, 2)),
        jl.Deconv2D(kernel_size=(3, 3), stride=(2, 2), n_out=5,
                    convolution_mode="same", activation="relu"),
        jl.Subsampling2D(kernel_size=(2, 2), stride=(2, 2),
                         pooling_type="pnorm", pnorm=2),
        jl.GlobalPooling(pooling_type="avg"),
        jl.ElementWiseMultiplication(n_out=5, activation="identity"),
        jl.CenterLossOutput(n_out=3, loss="mcxent", alpha=0.5, lambda_=0.1),
    ]).set_input_type(jit.convolutional(7, 6, 2))


def _net_1d(updater):
    """Conv1D (same, stride 2) -> MaxPooling1D -> Upsampling1D ->
    ZeroPadding1D -> Conv1D -> avg Subsampling1D -> global pool ->
    Output."""
    return JNNC(seed=4, updater=updater).list([
        jl.Conv1D(kernel_size=3, stride=2, n_out=5, convolution_mode="same",
                  activation="relu"),
        jl.Subsampling1D(kernel_size=2, stride=2, pooling_type="max"),
        jl.Upsampling1D(size=2),
        jl.ZeroPadding1D(pad=(1, 2)),
        jl.Conv1D(kernel_size=2, n_out=4, dilation=2, activation="tanh"),
        jl.Subsampling1D(kernel_size=2, stride=1, pooling_type="avg"),
        jl.GlobalPooling(pooling_type="max"),
        jl.Output(n_out=3, loss="mcxent"),
    ]).set_input_type(jit.recurrent(3, 12))


NETS = {"2d": (_net_2d, (5, 7, 6, 2)), "1d": (_net_1d, (5, 12, 3))}


def _pair(jconf):
    jnet = JMLN(jconf).init()
    rng = np.random.default_rng(9)
    params = {}
    for k, p in jax.tree_util.tree_map(np.asarray, jnet.params).items():
        params[k] = {n: ((rng.standard_normal(v.shape) * 0.3).astype(
            np.float32) if n == "b" else v) for n, v in p.items()}
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    assert tnet.conf.to_json() == jconf.to_json()
    interop.params_from_jax(tnet, params,
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _data(shape, step, n_out=3, drop_class=None):
    rng = np.random.default_rng(100 + step)
    x = rng.standard_normal(shape).astype(np.float32)
    cls = rng.integers(0, n_out, shape[0])
    if drop_class is not None:
        cls[cls == drop_class] = (drop_class + 1) % n_out
    return x, np.eye(n_out, dtype=np.float32)[cls]


def _same_nets(tnet, jnet):
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    tt = tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        assert np.abs(tt[k] - jt[k]).max() <= 1e-5, k
    for k, s in jnet.state.items():
        for n, v in s.items():
            assert np.abs(tnet.state[k][n].numpy() - np.asarray(v)).max() \
                <= 1e-5, (k, n)


def _fit_steps(jnet, tnet, shape, steps, drop_class=None):
    for step in range(steps):
        x, y = _data(shape, step, drop_class=drop_class)
        jnet.fit(x, y)
        tnet.fit(x, y)
        assert abs(tnet.score_ - float(jnet.score_)) <= \
            1e-5 * abs(float(jnet.score_)), step
        _same_nets(tnet, jnet)


@pytest.mark.parametrize("updater", ["adam", "nesterovs"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_network_of_new_layers_fits_as_jax(net, updater):
    """3 fit steps of each network in both packages, the 2-D one ending in
    a CenterLossOutput (its centers compared after every step; the second
    batch lacks class 1)."""
    upd = (jupd.Adam(learning_rate=1e-2) if updater == "adam"
           else jupd.Nesterovs(learning_rate=1e-2, momentum=0.9))
    conf, shape = NETS[net]
    jnet, tnet = _pair(conf(upd))
    x, _ = _data(shape, 0)
    assert _rel(tnet.output(x).numpy(), np.asarray(jnet.output(x))) <= 1e-5
    for step in range(3):
        _fit_steps(jnet, tnet, shape, 1,
                   drop_class=1 if step == 1 else None)
    assert _rel(tnet.output(x).numpy(), np.asarray(jnet.output(x))) <= 1e-5


# ----------------------------------------------------------- checkpoints
@pytest.mark.parametrize("net", sorted(NETS))
def test_jax_checkpoint_of_new_layers_restores_and_trains(tmp_path, net):
    """A JAX-written checkpoint zip of each network (every lifted layer
    class among them) restores in the port with its updater slots and
    centers, and trains 2 steps as the JAX copy does."""
    conf, shape = NETS[net]
    jnet, _ = _pair(conf(jupd.Adam(learning_rate=1e-2)))
    x, y = _data(shape, 7)
    jnet.fit(x, y)  # updater slots and centers not at their start
    path = tmp_path / f"{net}.zip"
    jser.write_model(jnet, str(path))
    tnet = restore_model(str(path), device="cpu")
    jnet = jser.restore_model(str(path))
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _same_nets(tnet, jnet)
    _fit_steps(jnet, tnet, shape, 2)


@pytest.mark.parametrize("cls", ["AutoEncoder", "RBM",
                                 "VariationalAutoencoder"])
def test_autoencoder_family_checkpoints_stay_refused(tmp_path, cls):
    """The three classes of A.8's second half, refused here until the port
    had them (the test keeps the name it had then): the refusal table is
    gone, each class's JSON reads into the port's class and round-trips,
    and a JAX-written checkpoint naming it restores with the JAX params
    and state."""
    d = JLayer.from_json({"type": cls, "n_out": 3}).to_json()
    assert not hasattr(tser, "_NOT_PORTED")
    assert Layer.from_json(d).to_json() == d
    jconf = JNNC(seed=3).list([JLayer.from_json(d),
                               jl.Output(n_out=2, loss="mcxent")]) \
        .set_input_type(jit.feed_forward(5))
    path = tmp_path / f"{cls}.zip"
    jnet = JMLN(jconf).init()
    jser.write_model(jnet, str(path))
    tnet = restore_model(str(path), device="cpu")
    assert type(tnet.layers[0]).__name__ == cls
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _same_nets(tnet, jnet)


# ------------------------------------------------------ CenterLossOutput
def test_center_loss_output_score_gradient_and_centers_match_jax():
    """compute_loss three times, each from the centers the last one left:
    the score, its gradient with respect to the input, W and b, and the new
    centers; the second batch lacks class 2, whose center stays."""
    layer = jl.CenterLossOutput(n_in=6, n_out=4, loss="mcxent", alpha=0.3,
                                lambda_=0.5)
    tlayer = Layer.from_json(layer.to_json())
    in_type = jit.feed_forward(6)
    params = _params(layer, in_type, np.random.default_rng(2))
    jstate = {"centers": jnp.asarray(_x((4, 6), 3) * 0.1)}
    tstate = {"centers": torch.tensor(np.asarray(jstate["centers"]))}
    assert tuple(tlayer.init_state(in_type)["centers"].shape) == (4, 6)
    for step in range(3):
        rng = np.random.default_rng(40 + step)
        x = rng.standard_normal((7, 6)).astype(np.float32)
        cls = rng.integers(0, 4, 7)
        if step == 1:
            cls[cls == 2] = 3
        y = np.eye(4, dtype=np.float32)[cls]

        def jfn(p, xx, st=jstate):
            s, _, new = layer.compute_loss(p, xx, jnp.asarray(y), state=st)
            return s, new

        (js, jnew), (jgp, jgx) = jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
        tp = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        tx = torch.tensor(x, requires_grad=True)
        ts, _, tnew = tlayer.compute_loss(tp, tx, torch.from_numpy(y),
                                          state=tstate)
        ts.backward()
        assert abs(ts.item() - float(js)) <= 1e-5 * abs(float(js)), step
        assert _rel(tx.grad.numpy(), jgx) <= 1e-5
        for k in params:
            assert _rel(tp[k].grad.numpy(), jgp[k]) <= 1e-5, k
        assert not tnew["centers"].requires_grad
        assert np.abs(tnew["centers"].numpy()
                      - np.asarray(jnew["centers"])).max() <= 1e-6, step
        if step == 1:
            np.testing.assert_array_equal(tnew["centers"][2].numpy(),
                                          tstate["centers"][2].numpy())
        jstate, tstate = jnew, tnew
