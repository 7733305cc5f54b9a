"""The zoo's six nets of this slice (Darknet19, VisionTransformer, TinyYOLO,
GoogLeNet, InceptionResNetV1, FaceNetNN4Small2) in the port, against the
JAX package's zoo.

At full width: each `conf()` gives the JAX package's JSON, and the
initialized networks hold the same parameter count and the same parameter
and state shapes. At a reduced input (the widths as published; a smaller
image, fewer classes, batch 2 or 4): the JAX network's weights carried
across with `interop.params_from_jax`, the output within 1e-5 of its
largest magnitude and one `fit` step with the zoo's own updater: the score
within 1e-5 relative, every updater slot (each a multiple of the gradient,
or of its square) within 1e-4 of its leaf's largest magnitude, running
state (BatchNorm statistics, FaceNet's CenterLossOutput centers) within
1e-5 absolute, and under Nesterovs (Darknet19, GoogLeNet) the params within
1e-5 absolute. Adam's and RmsProp's first step divides by the gradient's
magnitude, which turns last-bit differences of near-zero gradient entries
into steps as large as the learning rate, so there the slots carry the
check. GoogLeNet's dropout draws JAX's keys (`tests/torch_keys.py`).
"""
import jax
import numpy as np
import pytest

import deeplearning4j_tpu.zoo as jzoo
from deeplearning4j_tpu.models import ComputationGraph as JCG
import deeplearning4j_tpu_torch.zoo as tzoo
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.models import serialization as tser
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from test_torch_objdetect import yolo_labels
from torch_keys import JaxKeys

NETS = ["Darknet19", "VisionTransformer", "TinyYOLO", "GoogLeNet",
        "InceptionResNetV1", "FaceNetNN4Small2"]

# reduced inputs: (zoo kwargs, batch)
REDUCED = {
    "Darknet19": (dict(input_shape=(64, 64, 3), num_classes=10), 2),
    "VisionTransformer": (dict(input_shape=(16, 16, 3)), 4),
    "TinyYOLO": (dict(input_shape=(64, 64, 3), num_classes=4), 2),
    "GoogLeNet": (dict(input_shape=(32, 32, 3), num_classes=10), 2),
    "InceptionResNetV1": (dict(input_shape=(32, 32, 3), num_classes=16), 2),
    "FaceNetNN4Small2": (dict(input_shape=(32, 32, 3), num_classes=10), 4),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flat_items(tree)}


@pytest.mark.parametrize("name", NETS)
def test_zoo_conf_json_and_full_width_params_match_jax(name):
    """At the zoo's defaults: the same JSON, parameter count, and
    parameter and state names and shapes (in the interchange layout)."""
    jconf = getattr(jzoo, name)().conf()
    assert getattr(tzoo, name)().conf().to_json() == jconf.to_json()
    tnet = getattr(tzoo, name)().init(device="cpu")
    jnet = getattr(jzoo, name)().init()
    assert tnet.num_params() == jnet.num_params() > 0
    params, state = interop.params_to_jax(tnet)
    assert _shapes(params) == _shapes(jnet.params)
    assert _shapes(state) == _shapes(jnet.state)


def _pair(name):
    kw, batch = REDUCED[name]
    jnet = getattr(jzoo, name)(**kw).init()
    conf_json = jnet.conf.to_json()
    if isinstance(jnet, JCG):
        tnet = ComputationGraph(ComputationGraphConfiguration.from_json(
            conf_json)).init(device="cpu")
    else:
        tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf_json)).init(device="cpu")
    assert tnet.num_params() == jnet.num_params()
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    tnet.draws = JaxKeys.for_net(tnet.conf.defaults.seed)
    return jnet, tnet, kw, batch


def _batch(name, kw, batch, tnet):
    rng = np.random.default_rng(len(name))
    h, w, c = kw["input_shape"]
    x = rng.standard_normal((batch, h, w, c)).astype(np.float32)
    if name == "TinyYOLO":
        grid = tnet.output(x[:1]).shape[1:3]
        return x, yolo_labels(rng, batch, grid[0], grid[1],
                              kw["num_classes"])
    n_out = kw.get("num_classes", 10)
    return x, np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, batch)]


@pytest.mark.parametrize("name", NETS)
def test_zoo_output_and_fit_step_match_jax(name):
    jnet, tnet, kw, batch = _pair(name)
    x, y = _batch(name, kw, batch, tnet)
    jout = np.asarray(jnet.output(x))
    tout = tnet.output(x).numpy()
    assert _rel(tout, jout) <= 1e-5
    jnet.fit(x, y)
    tnet.fit(x, y)
    js = float(jnet.score_)
    assert abs(tnet.score_ - js) <= 1e-5 * abs(js)
    jslots = dict(tser._key_parts(jax.tree_util.tree_map(np.asarray,
                                                         jnet.opt_state)))
    tslots = dict(tser._key_parts(interop.opt_state_to_jax(tnet)))
    assert sorted(tslots) == sorted(jslots)
    for k, v in jslots.items():
        assert _rel(tslots[k], v) <= 1e-4, k
    jt = dict(tser._key_parts(jax.tree_util.tree_map(np.asarray,
                                                     jnet.params)))
    tt = tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    if name in ("Darknet19", "GoogLeNet"):  # Nesterovs
        for k, v in tt.items():
            assert np.abs(v - jt[k]).max() <= 1e-5, k
    for k, s in jnet.state.items():
        for n, v in s.items():
            assert np.abs(tnet.state[k][n].numpy() - np.asarray(v)).max() \
                <= 1e-5, (k, n)
