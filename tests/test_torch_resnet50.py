"""The slice as a whole: zoo ResNet-50 in the port against the JAX package's.

The JAX net is built as tests/test_zoo.py builds it (10 classes, 64x64x3),
given non-trivial BatchNorm running stats and gamma/beta, and carried into
the port with `interop.params_from_jax`. Both then run the same numpy input
made from a seed. Built once per module.

Tolerance: every vertex's activation within 1e-4 of that activation's
largest magnitude (float32 on both sides; convolutions sum in another order
in each CPU backend, and the differences pass through ~50 layers).
"""
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.zoo import ResNet50 as TResNet50

SHAPE = (64, 64, 3)
TOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(2024)
    jnet = JResNet50(num_classes=10, input_shape=SHAPE).init()
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    state = jax.tree_util.tree_map(np.asarray, jnet.state)
    for name, st in state.items():
        if "mean" not in st:
            continue
        c = st["mean"].shape[0]
        st["mean"] = (rng.standard_normal(c) * 0.5).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        params[name]["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        params[name]["beta"] = (rng.standard_normal(c) * 0.2).astype(
            np.float32)
    jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jnet.state = jax.tree_util.tree_map(jax.numpy.asarray, state)
    tnet = TResNet50(num_classes=10, input_shape=SHAPE).init(device="cpu")
    interop.params_from_jax(tnet, params, state)
    x = rng.standard_normal((2,) + SHAPE).astype(np.float32)
    return jnet, tnet, params, state, x


@pytest.fixture(scope="module")
def jax_acts(nets):
    jnet, _, _, _, x = nets
    return jnet.feed_forward(x)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_param_tables_are_identical(nets):
    jnet, tnet, _, _, _ = nets
    jt, tt = jnet.get_param_table(), tnet.get_param_table()
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)
    assert tnet.num_params() == jnet.num_params()


def test_feed_forward_matches_vertex_by_vertex(nets, jax_acts):
    jnet, tnet, _, _, x = nets
    tacts = tnet.feed_forward(x)
    names = list(jnet.conf.network_inputs) + jnet.topo
    assert tnet.topo == jnet.topo and len(tacts) == len(jax_acts)
    errs = {}
    for name, got, want in zip(names, tacts, jax_acts):
        assert tuple(got.shape) == want.shape, name
        errs[name] = _rel(got, np.asarray(want))
    worst = max(errs, key=errs.get)
    assert errs[worst] < TOL, (worst, errs[worst])


def test_bn_epilogues_are_contiguous_nhwc(nets):
    """Every conv output reaches bn_act as a dense [rows, c] matrix (the
    check bn_act makes on the card too)."""
    _, tnet, _, _, x = nets
    acts = dict(zip(["in"] + tnet.topo, tnet.feed_forward(x)))
    convs = [n for n in tnet.topo if n.endswith("_conv")]
    assert len(convs) == 53
    assert all(acts[n].is_contiguous() and acts[n].dim() == 4 for n in convs)


def test_output_matches(nets, jax_acts):
    jnet, tnet, _, _, x = nets
    got = tnet.output(x)
    want = np.asarray(jax_acts[-1])
    assert got.shape == (2, 10) and got.device.type == "cpu"
    assert _rel(got, want) < TOL
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)


def test_config_json_matches_jax():
    jconf = JResNet50(num_classes=10, input_shape=SHAPE).conf()
    tconf = TResNet50(num_classes=10, input_shape=SHAPE).conf()
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert back.topological_order() == jconf.topological_order()


def test_init_is_seeded_with_channels_last_kernels():
    a = TResNet50(num_classes=10, input_shape=(32, 32, 3)).init(device="cpu")
    b = TResNet50(num_classes=10, input_shape=(32, 32, 3)).init(device="cpu")
    c = TResNet50(num_classes=10, input_shape=(32, 32, 3), seed=5).init(
        device="cpu")
    ta, tb, tc = (n.get_param_table() for n in (a, b, c))
    k = "stem_conv/W"
    np.testing.assert_array_equal(ta[k], tb[k])
    assert not np.array_equal(ta[k], tc[k])
    assert a.params["stem_conv"]["W"].is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("fault", ["missing_vertex", "extra_key",
                                   "bad_shape", "missing_state"])
def test_params_from_jax_rejects_mismatches(nets, fault):
    _, _, params, state, _ = nets
    tnet = TResNet50(num_classes=10, input_shape=SHAPE).init(device="cpu")
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    if fault == "missing_vertex":
        del params["out"]
    elif fault == "extra_key":
        params["stem_bn"]["extra"] = np.zeros(64, np.float32)
    elif fault == "bad_shape":
        params["out"]["W"] = np.zeros((3, 10), np.float32)
    else:
        del state["stem_bn"]["var"]
    before = tnet.get_param_table()["out/W"]
    with pytest.raises(ValueError):
        interop.params_from_jax(tnet, params, state)
    np.testing.assert_array_equal(tnet.get_param_table()["out/W"], before)
