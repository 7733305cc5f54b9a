"""The port's input preprocessors, the vertices the Keras importer creates
(MergeVertex, ReshapeVertex, PreprocessorVertex) and DropoutLayer against
the JAX package.

Every case feeds the same seeded numpy input to both packages. Reshapes and
concatenations move values without arithmetic, so outputs must be equal
bit for bit; the networks that run layers around them agree to 1e-5 of the
output's largest magnitude (float32 on both sides, sums in another order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import graph_vertices as jgv
from deeplearning4j_tpu.nn import inputs as jit_
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn import preprocessors as jpp
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JCGC,
)
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import graph_vertices as tgv
from deeplearning4j_tpu_torch.nn import inputs as tit
from deeplearning4j_tpu_torch.nn import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DropoutLayer, Layer

# (name, constructor kwargs, input shape, input type as JSON)
PREPROCESSORS = [
    ("CnnToFeedForward", {"height": 3, "width": 4, "channels": 5},
     (2, 3, 4, 5), {"kind": "cnn", "height": 3, "width": 4, "channels": 5}),
    ("FeedForwardToCnn", {"height": 3, "width": 4, "channels": 5},
     (2, 60), {"kind": "ff", "size": 60}),
    ("FeedForwardToCnn", {"height": 3, "width": 4, "channels": 5},
     (2, 3, 4, 5), {"kind": "cnn", "height": 3, "width": 4, "channels": 5}),
    ("CnnToRnn", {"height": 3, "width": 4, "channels": 5},
     (2, 3, 4, 5), {"kind": "cnn", "height": 3, "width": 4, "channels": 5}),
    ("CnnToTokens", {"height": 3, "width": 4, "channels": 5},
     (2, 3, 4, 5), {"kind": "cnn", "height": 3, "width": 4, "channels": 5}),
    ("RnnToCnn", {"height": 2, "width": 3, "channels": 2},
     (2, 4, 12), {"kind": "rnn", "size": 12, "timesteps": 4}),
    ("FeedForwardToRnn", {}, (2, 6), {"kind": "ff", "size": 6}),
    ("FeedForwardToRnn", {}, (2, 4, 6),
     {"kind": "rnn", "size": 6, "timesteps": 4}),
    ("RnnToFeedForward", {}, (2, 4, 6),
     {"kind": "rnn", "size": 6, "timesteps": 4}),
    ("ReshapePreprocessor", {"target_shape": (3, 20)}, (2, 60),
     {"kind": "ff", "size": 60}),
    ("ReshapePreprocessor", {"target_shape": (3, 4, 5)}, (2, 60),
     {"kind": "ff", "size": 60}),
    ("ReshapePreprocessor", {"target_shape": (60,)}, (2, 3, 4, 5),
     {"kind": "cnn", "height": 3, "width": 4, "channels": 5}),
]


def _pair(name, kw):
    return getattr(jpp, name)(**kw), getattr(tpp, name)(**kw)


def _same_type(t, j):
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("name,kw,shape,in_type", PREPROCESSORS,
                         ids=[f"{p[0]}-{len(p[2])}d-{i}"
                              for i, p in enumerate(PREPROCESSORS)])
def test_preprocessor_matches_jax(name, kw, shape, in_type):
    jp, tp = _pair(name, kw)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jp.transform(jnp.asarray(x)))
    got = tp.transform(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    _same_type(tp.output_type(tit.from_json(in_type)),
               jp.output_type(jit_.from_json(in_type)))
    # the JSON is the same, and each package reads the other's
    assert json.loads(json.dumps(tp.to_json())) == \
        json.loads(json.dumps(jp.to_json()))
    back = tpp.InputPreProcessor.from_json(
        json.loads(json.dumps(jp.to_json())))
    assert type(back) is type(tp)
    np.testing.assert_array_equal(back.transform(torch.from_numpy(x)).numpy(),
                                  want)


def test_composable_matches_jax_and_round_trips():
    kw = {"height": 3, "width": 4, "channels": 5}
    jp = jpp.Composable([jpp.FeedForwardToCnn(**kw), jpp.CnnToRnn(**kw)])
    tp = tpp.Composable([tpp.FeedForwardToCnn(**kw), tpp.CnnToRnn(**kw)])
    x = np.random.default_rng(4).standard_normal((2, 60)).astype(np.float32)
    np.testing.assert_array_equal(tp.transform(torch.from_numpy(x)).numpy(),
                                  np.asarray(jp.transform(jnp.asarray(x))))
    _same_type(tp.output_type(tit.feed_forward(60)),
               jp.output_type(jit_.feed_forward(60)))
    assert tp.to_json() == jp.to_json()
    back = tpp.InputPreProcessor.from_json(jp.to_json())
    assert isinstance(back, tpp.Composable)
    assert [type(p).__name__ for p in back.processors] == [
        "FeedForwardToCnn", "CnnToRnn"]


def _jax_mln_with_preprocessors():
    """Dense -> Reshape to 4x4x2 -> Conv2D -> Flatten -> Output: the layer
    after each preprocessor sees its output."""
    conf = (JNNC(seed=11).list([
        jlayers.Dense(n_out=32, activation="tanh"),
        jlayers.Conv2D(kernel_size=(3, 2), n_out=3, activation="relu",
                       convolution_mode="same"),
        jlayers.Output(n_out=4, activation="softmax", loss="mcxent")])
        .input_preprocessor(1, jpp.ReshapePreprocessor(target_shape=(4, 4, 2)))
        .input_preprocessor(2, jpp.CnnToFeedForward())
        .set_input_type(jit_.feed_forward(6)))
    return JMLN(conf.build()).init()


def test_jax_config_with_preprocessors_reads_and_runs_the_same():
    """A JAX MultiLayerConfiguration's JSON with preprocessors is read by
    the port's from_json; with the JAX weights carried across, the port's
    walk applies each preprocessor before its layer, as the JAX one does."""
    jnet = _jax_mln_with_preprocessors()
    text = jnet.conf.to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert json.loads(conf.to_json()) == json.loads(text)
    assert [type(conf.input_preprocessors[i]).__name__ for i in (1, 2)] == [
        "ReshapePreprocessor", "CnnToFeedForward"]
    assert conf.layer_input_types()[1] == tit.convolutional(4, 4, 2)
    tnet = MultiLayerNetwork(conf).init(device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    state = jax.tree_util.tree_map(np.asarray, jnet.state)
    interop.params_from_jax(tnet, params, state)
    x = np.random.default_rng(5).standard_normal((3, 6)).astype(np.float32)
    want = jnet.feed_forward(x)
    got = tnet.feed_forward(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# ---- the vertices the Keras importer makes ----

def _apply(v, xs, jax_side):
    if jax_side:
        out, _ = v.apply({}, [jnp.asarray(x) for x in xs], state={},
                         train=False, rng=None)
        return np.asarray(out)
    out, _ = v.apply({}, [torch.from_numpy(x) for x in xs], state={},
                     train=False)
    return out.numpy()


@pytest.mark.parametrize("shapes,types", [
    ([(2, 5, 5, 3), (2, 5, 5, 4), (2, 5, 5, 1)],
     [{"kind": "cnn", "height": 5, "width": 5, "channels": c}
      for c in (3, 4, 1)]),
    ([(2, 7, 3), (2, 7, 2)],
     [{"kind": "rnn", "size": s, "timesteps": 7} for s in (3, 2)]),
    ([(2, 3), (2, 6)], [{"kind": "ff", "size": s} for s in (3, 6)]),
], ids=["nhwc-channels", "btf-features", "ff"])
def test_merge_vertex_matches_jax(shapes, types):
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    np.testing.assert_array_equal(_apply(tgv.MergeVertex(), xs, False),
                                  _apply(jgv.MergeVertex(), xs, True))
    _same_type(tgv.MergeVertex().output_type([tit.from_json(t)
                                              for t in types]),
               jgv.MergeVertex().output_type([jit_.from_json(t)
                                              for t in types]))


@pytest.mark.parametrize("new_shape", [(24,), (4, 6), (2, 3, 4)])
def test_reshape_and_preprocessor_vertices_match_jax(new_shape):
    x = np.random.default_rng(7).standard_normal((3, 2, 3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        _apply(tgv.ReshapeVertex(new_shape=new_shape), [x], False),
        _apply(jgv.ReshapeVertex(new_shape=new_shape), [x], True))
    _same_type(tgv.ReshapeVertex(new_shape=new_shape).output_type(
        [tit.convolutional(2, 3, 4)]),
        jgv.ReshapeVertex(new_shape=new_shape).output_type(
            [jit_.convolutional(2, 3, 4)]))
    tv = tgv.PreprocessorVertex(preprocessor=tpp.CnnToFeedForward())
    jv = jgv.PreprocessorVertex(preprocessor=jpp.CnnToFeedForward())
    np.testing.assert_array_equal(_apply(tv, [x], False),
                                  _apply(jv, [x], True))
    _same_type(tv.output_type([tit.convolutional(2, 3, 4)]),
               jv.output_type([jit_.convolutional(2, 3, 4)]))


def _graph_conf(nnc, gv, pp, layers_mod, it_mod):
    return (nnc(seed=2).graph()
            .add_inputs("in")
            .add_layer("c1", layers_mod.Conv2D(kernel_size=(1, 1), n_out=2),
                       "in")
            .add_layer("c2", layers_mod.Conv2D(kernel_size=(1, 1), n_out=3),
                       "in")
            .add_vertex("cat", gv.MergeVertex(), "c1", "c2")
            .add_vertex("flat", gv.PreprocessorVertex(
                preprocessor=pp.CnnToFeedForward()), "cat")
            .add_vertex("rs", gv.ReshapeVertex(new_shape=(4, 20)), "flat")
            .add_vertex("back", gv.ReshapeVertex(new_shape=(80,)), "rs")
            .add_layer("out", layers_mod.Output(n_out=3, activation="softmax"),
                       "back")
            .set_outputs("out")
            .set_input_types(it_mod.convolutional(4, 4, 3)))


def test_graph_json_round_trips_the_new_vertices():
    """GraphVertex.to_json / from_json round-trip a PreprocessorVertex (its
    preprocessor nested as JSON, like a LayerVertex's layer), MergeVertex
    and ReshapeVertex; the JAX package reads the port's JSON, and both
    graphs compute the same function."""
    from deeplearning4j_tpu.models import ComputationGraph as JCG
    from deeplearning4j_tpu_torch.nn import layers as tlayers
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    tconf = _graph_conf(NeuralNetConfiguration, tgv, tpp, tlayers, tit)
    text = tconf.build().to_json()
    d = json.loads(text)
    assert d["vertices"]["flat"] == {
        "type": "PreprocessorVertex",
        "preprocessor": {"type": "CnnToFeedForward", "height": 0,
                         "width": 0, "channels": 0}}
    assert d["vertices"]["cat"] == {"type": "MergeVertex"}
    back = ComputationGraphConfiguration.from_json(text)
    assert isinstance(back.vertices["flat"].preprocessor,
                      tpp.CnnToFeedForward)
    assert back.to_json() == text
    jconf = JCGC.from_json(text)
    jnet = JCG(jconf).init()
    tnet = ComputationGraph(back).init(device="cpu")
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    x = np.random.default_rng(8).standard_normal((2, 4, 4, 3)).astype(
        np.float32)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---- DropoutLayer ----

def test_dropout_layer_is_the_identity_at_inference_and_matches_jax_json():
    """The identity at inference; at train time the JAX layer's mask (its
    key replayed into the port's draws) scaled by 1/p, equal to JAX's."""
    from torch_keys import JaxKeys

    jl = jlayers.DropoutLayer(dropout=0.75)
    tl = Layer.from_json(jl.to_json())
    assert isinstance(tl, DropoutLayer) and tl.to_json() == jl.to_json()
    assert tl.output_type(tit.recurrent(5, 3)) == tit.recurrent(5, 3)
    x = np.random.default_rng(9).standard_normal((2, 3, 5)).astype(
        np.float32)
    want, _ = jl.apply({}, jnp.asarray(x), state={}, train=False, rng=None)
    got, _ = tl.apply({}, torch.from_numpy(x), state={}, train=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = jax.random.PRNGKey(4)
    want, _ = jl.apply({}, jnp.asarray(x), state={}, train=True, rng=key)
    got, _ = tl.apply({}, torch.from_numpy(x), state={}, train=True,
                      rng=JaxKeys(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert 0 < int((got == 0).sum()) < x.size


def test_fit_refuses_a_network_with_a_dropout_layer():
    """A network with a DropoutLayer trains: 3 steps with the JAX
    network's keys replayed into the port's draws equal the JAX fit."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import Dense, Output
    from torch_keys import JaxKeys

    conf = NeuralNetConfiguration(seed=1).list([
        Dense(n_out=4, activation="relu"), DropoutLayer(dropout=0.5),
        Output(n_out=2, activation="softmax")]).set_input_type(
        tit.feed_forward(3))
    text = conf.build().to_json()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(text)).init(
        device="cpu")
    jnet = JMLN(JMLC.from_json(text)).init()
    interop.params_from_jax(
        net, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    net.draws = JaxKeys.for_net(1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    assert net.output(x).shape == (6, 2)
    for _ in range(3):
        net.fit(x, y)
        jnet.fit(x, y)
        assert abs(net.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    got = net.get_param_table()
    for k, v in jnet.get_param_table().items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-5,
                                   err_msg=k)
