"""The port's layers, vertices, activations, initializers and config JSON
against the JAX package.

Each layer case builds the JAX layer, turns its config into the port's
through JSON (Layer.to_json / from_json), carries its weights across with
`interop.layer_params_from_jax`, and feeds both the same numpy input made
from a seed. Tolerance: float32 relative 1e-5 of the output's largest
magnitude (the two CPU backends sum convolutions in another order), unless
a case states otherwise.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import initializers as jinit
from deeplearning4j_tpu.nn import inputs as jit_
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.graph_vertices import ElementWiseVertex as JEW
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import initializers as tinit
from deeplearning4j_tpu_torch.nn.graph_vertices import ElementWiseVertex as TEW
from deeplearning4j_tpu_torch.nn.layers.base import Layer as TLayer


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _random_bn(jlayer_params, jstate, rng):
    """Non-trivial running stats and gamma/beta (an identity BN would hide
    a wrong fold)."""
    c = jstate["mean"].shape[0]
    state = {"mean": (rng.standard_normal(c) * 0.5).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    params = {k: np.asarray(v) for k, v in jlayer_params.items()}
    if params:
        params["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        params["beta"] = (rng.standard_normal(c) * 0.2).astype(np.float32)
    return params, state


def _run_both(jlayer, in_type, x, seed=0, bn_stats=False):
    """(jax output, port output) of one layer on input x."""
    rng = np.random.default_rng(seed)
    jparams = jlayer.init_params(jax.random.PRNGKey(seed), in_type)
    jstate = jlayer.init_state(in_type)
    params = {k: np.asarray(v) for k, v in jparams.items()}
    state = {k: np.asarray(v) for k, v in jstate.items()}
    if bn_stats:
        params, state = _random_bn(jparams, jstate, rng)
    want, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(x), train=False, rng=None,
                           state={k: jnp.asarray(v) for k, v in state.items()})
    tlayer = TLayer.from_json(jlayer.to_json())
    assert type(tlayer).__name__ == type(jlayer).__name__
    tparams = interop.layer_params_from_jax(tlayer, params)
    tstate = interop.layer_params_from_jax(None, state)
    got, _ = tlayer.apply(tparams, _torch_in(x), state=tstate, train=False)
    return np.asarray(want), got


def _torch_in(x):
    if x.dtype == jnp.bfloat16:  # numpy's bfloat16 (ml_dtypes)
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


def _nhwc(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("mode,kernel,stride,size", [
    ("same", 3, 1, 8), ("same", 3, 2, 9), ("same", 7, 2, 11),
    ("same", 1, 2, 9), ("truncate", 3, 2, 9), ("truncate", 5, 1, 8),
])
def test_conv2d_matches_jax(mode, kernel, stride, size):
    layer = jlayers.Conv2D(kernel_size=(kernel, kernel), stride=(stride, stride),
                           n_out=6, convolution_mode=mode, activation="relu",
                           bias_init=0.1, padding=(1, 1))
    in_type = jit_.convolutional(size, size, 4)
    x = _nhwc((2, size, size, 4))
    want, got = _run_both(layer, in_type, x)
    assert got.is_contiguous()  # NHWC-contiguous, ready for bn_act
    assert want.shape[1:] == layer.output_type(in_type).shape()[1:]
    assert _rel_err(got, want) < 1e-5


def test_conv2d_interchange_layout_round_trips():
    tlayer = TLayer.from_json(jlayers.Conv2D(kernel_size=(3, 5), n_out=7)
                              .to_json())
    hwio = torch.from_numpy(_nhwc((3, 5, 4, 7)))
    oihw = tlayer.from_interchange("W", hwio)
    assert oihw.shape == (7, 4, 3, 5)
    assert oihw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(tlayer.to_interchange("W", oihw), hwio)


@pytest.mark.parametrize("mode,pool,size", [
    ("same", "max", 9), ("same", "max", 10), ("truncate", "max", 9),
    ("same", "avg", 9), ("truncate", "avg", 8),
])
def test_subsampling2d_matches_jax(mode, pool, size):
    layer = jlayers.Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                                  convolution_mode=mode, pooling_type=pool)
    want, got = _run_both(layer, jit_.convolutional(size, size, 5),
                          _nhwc((2, size, size, 5)))
    assert _rel_err(got, want) < 1e-6


@pytest.mark.parametrize("act", ["relu", "identity", "tanh", None])
def test_batchnorm_inference_matches_jax(act):
    layer = jlayers.BatchNorm(activation=act)
    want, got = _run_both(layer, jit_.convolutional(4, 4, 16),
                          _nhwc((2, 4, 4, 16)), bn_stats=True)
    assert _rel_err(got, want) < 1e-6


def test_batchnorm_locked_gamma_beta_matches_jax():
    layer = jlayers.BatchNorm(activation="relu", lock_gamma_beta=True)
    want, got = _run_both(layer, jit_.feed_forward(12),
                          _nhwc((5, 12)), bn_stats=True)
    assert _rel_err(got, want) < 1e-6


def test_conv_bn_mixed_precision_matches_jax():
    """bf16 activations under both packages' mixed policy: a conv then a
    relu BatchNorm, compared at bf16 tolerance (2 ulp relative to the
    output's largest magnitude: each side rounds conv output and epilogue
    to bfloat16)."""
    conv = jlayers.Conv2D(kernel_size=(3, 3), n_out=8, convolution_mode="same",
                          has_bias=False)
    bn = jlayers.BatchNorm(activation="relu")
    x = _nhwc((2, 6, 6, 4))
    with jdtypes.mixed(), tdtypes.mixed():
        want_c, got_c = _run_both(conv, jit_.convolutional(6, 6, 4), x)
        assert got_c.dtype == torch.bfloat16
        xc = np.asarray(got_c.float().numpy())
        want, got = _run_both(bn, jit_.convolutional(6, 6, 8),
                              xc.astype(jnp.bfloat16), bn_stats=True)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got_c.float(), np.asarray(want_c, np.float32)) < 2 ** -6
    assert _rel_err(got.float(), np.asarray(want, np.float32)) < 2 ** -6


@pytest.mark.parametrize("pool", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("rank", [4, 3])
def test_global_pooling_matches_jax(pool, rank):
    layer = jlayers.GlobalPooling(pooling_type=pool)
    if rank == 4:
        in_type, x = jit_.convolutional(5, 5, 6), _nhwc((2, 5, 5, 6))
    else:
        in_type, x = jit_.recurrent(6, 7), _nhwc((2, 7, 6))
    want, got = _run_both(layer, in_type, x)
    assert _rel_err(got, want) < 1e-6


@pytest.mark.parametrize("in_shape", [(4, 12), (3, 2, 2, 3)])
def test_output_softmax_matches_jax(in_shape):
    layer = jlayers.Output(n_out=5, loss="mcxent")
    in_type = (jit_.feed_forward(12) if len(in_shape) == 2
               else jit_.convolutional(2, 2, 3))
    want, got = _run_both(layer, in_type, _nhwc(in_shape))
    assert _rel_err(got, want) < 1e-6
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "tanh", None])
def test_dense_matches_jax(act):
    layer = jlayers.Dense(n_out=7, activation=act, bias_init=0.3)
    want, got = _run_both(layer, jit_.feed_forward(9), _nhwc((4, 9)))
    assert _rel_err(got, want) < 1e-6


def test_activation_layer_matches_jax():
    layer = jlayers.Activation(activation="relu")
    want, got = _run_both(layer, jit_.convolutional(3, 3, 2),
                          _nhwc((2, 3, 3, 2)))
    assert _rel_err(got, want) == 0


@pytest.mark.parametrize("op", ["add", "subtract", "product", "average",
                                "max"])
def test_elementwise_vertex_matches_jax(op):
    xs = [_nhwc((2, 3, 3, 4), seed=s) for s in (1, 2, 3)]
    n = 2 if op == "subtract" else 3
    want, _ = JEW(op=op).apply({}, [jnp.asarray(x) for x in xs[:n]],
                               state={}, train=False, rng=None)
    got, _ = TEW(op=op).apply({}, [torch.from_numpy(x) for x in xs[:n]],
                              state={}, train=False)
    assert _rel_err(got, want) < 1e-6


@pytest.mark.parametrize("name", sorted(set(jact.names()) | {"leakyrelu:0.3"}))
def test_activation_registry_matches_jax(name):
    x = np.linspace(-4.0, 4.0, 41, dtype=np.float32).reshape(1, 41)
    want = np.asarray(jact.get(name)(jnp.asarray(x)))
    got = tact.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_activation_registries_name_the_same_functions():
    assert tact.names() == jact.names()
    with pytest.raises(ValueError):
        tact.get("no-such-activation")


@pytest.mark.parametrize("scheme,shape,std,bound", [
    ("xavier", (64, 128), np.sqrt(2.0 / 192), None),
    ("relu", (3, 3, 64, 32), np.sqrt(2.0 / 576), None),
    ("normal", (256, 64), 1.0 / 16, None),
    ("xavier_uniform", (64, 128), np.sqrt(6.0 / 192) / np.sqrt(3),
     np.sqrt(6.0 / 192)),
    ("lecun_uniform", (100, 50), np.sqrt(3.0 / 100) / np.sqrt(3),
     np.sqrt(3.0 / 100)),
])
def test_initializer_distribution_matches_jax(scheme, shape, std, bound):
    """Streams differ between jax.random and torch.Generator: the schemes
    must agree in distribution (mean 0, the scheme's std within 5% at
    these sizes, the uniform bound respected)."""
    gen = torch.Generator().manual_seed(0)
    w = tinit.init(scheme, gen, shape).numpy()
    jw = np.asarray(jinit.init(scheme, jax.random.PRNGKey(0), shape))
    for arr in (w, jw):
        assert arr.dtype == np.float32 and arr.shape == shape
        assert abs(arr.mean()) < 0.05 * std + 3 * std / np.sqrt(arr.size)
        assert abs(arr.std() / std - 1.0) < 0.05
        if bound is not None:
            assert np.abs(arr).max() <= bound
    assert abs(w.std() / jw.std() - 1.0) < 0.05


@pytest.mark.parametrize("scheme", ["zero", "ones", "identity"])
def test_deterministic_initializers_equal_jax(scheme):
    shape = (6, 6)
    got = tinit.init(scheme, torch.Generator().manual_seed(0), shape).numpy()
    want = np.asarray(jinit.init(scheme, jax.random.PRNGKey(0), shape))
    np.testing.assert_array_equal(got, want)


def test_layer_json_round_trips_through_both_packages():
    layers = [jlayers.Conv2D(kernel_size=(7, 7), stride=(2, 2), n_out=64,
                             convolution_mode="same", has_bias=False),
              jlayers.BatchNorm(activation="relu", eps=1e-3),
              jlayers.Subsampling2D(kernel_size=(3, 3), stride=(2, 2),
                                    convolution_mode="same"),
              jlayers.GlobalPooling(pooling_type="avg"),
              jlayers.Dense(n_out=10, activation="relu"),
              jlayers.Output(n_out=10, loss="mcxent"),
              jlayers.Activation(activation="relu")]
    for jl in layers:
        d = jl.to_json()
        tl = TLayer.from_json(json.loads(json.dumps(d)))
        assert tl.to_json() == d
        assert JLayer.from_json(tl.to_json()).to_json() == d


def test_unported_layer_type_is_named():
    with pytest.raises(ValueError, match="not ported"):
        TLayer.from_json(jlayers.LSTM(n_out=4).to_json())
