"""Masks and truncated BPTT through the ComputationGraph, and the recurrent
layers and vertices they need (GravesBidirectionalLSTM, SimpleRnn,
LastTimeStep, masked GlobalPooling, LastTimeStepVertex,
DuplicateToTimeSeriesVertex), against the JAX package.

Inputs, masks and labels are made with numpy from a seed; weights are
made by the JAX package (peepholes and biases made nonzero) and carried
into the port with `interop.params_from_jax`; dropout draws JAX's keys
(`tests/torch_keys.py`). Graph configs are built by the JAX package and
read by the port from their JSON. Tolerances: a layer's or vertex's output
and gradients 1e-5 of each one's largest magnitude (float32 sums in
another order); training as tests/test_torch_rnn_training.py holds it:
per-step scores 1e-5 relative, params 1e-5 absolute, updater slots (RmsProp's
g2, Adam's m and v) 1e-4 of each leaf's largest magnitude.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import graph_vertices as jgv
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import graph_vertices as tgv
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
from torch_keys import JaxKeys

VOCAB, N = 11, 16


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mask(kind, b, t):
    """None, right-padded rows (row 0 live throughout), or right-padded
    rows with row 1 wholly masked."""
    if kind == "none":
        return None
    lengths = np.random.default_rng(b * 100 + t).integers(1, t + 1, b)
    lengths[0] = t
    if kind == "dead-row":
        lengths[1] = 0
    return (np.arange(t)[None] < lengths[:, None]).astype(np.float32)


def _nonzero(params, rng, keys=("b", "pi", "pf", "po")):
    """Params with biases and peepholes drawn nonzero (init makes them 0
    or 1), so that a misplaced one shows."""
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k.split("_")[-1] in keys:
            v = (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        out[k] = v
    return out


# --------------------------------------------------------------- layers
LAYERS = {
    "GravesBidirectionalLSTM": lambda **kw: dict(n_out=6, activation="tanh",
                                                 **kw),
    "SimpleRnn": lambda **kw: dict(n_out=6, activation="tanh", **kw),
    "LastTimeStep": lambda **kw: dict(underlying=dict(
        type="GravesLSTM", n_out=6, activation="tanh", **kw)),
}


def _layer_pair(name, dropout=None):
    extra = {} if dropout is None else {"dropout": dropout}
    d = dict(type=name, **LAYERS[name](**extra))
    return Layer.from_json(d), JLayer.from_json(d)


@pytest.mark.parametrize("mask", ["none", "padded", "dead-row", "dropout"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_recurrent_layer_matches_jax(name, mask):
    """Forward and the gradients of sum(out * w), w seeded, with respect to
    the input and every param, at (5, 7, 4); "dropout" trains with a
    retain probability of 0.6 and the padded mask, its masks from JAX's
    keys."""
    rng = np.random.default_rng(len(name) * 10 + len(mask))
    b, t, f = 5, 7, 4
    dropout = 0.6 if mask == "dropout" else None
    tlayer, jlayer = _layer_pair(name, dropout)
    assert tlayer.to_json() == jlayer.to_json()
    assert JLayer.from_json(tlayer.to_json()).to_json() == tlayer.to_json()
    params = _nonzero(jlayer.init_params(jax.random.PRNGKey(1),
                                         jit.recurrent(f, t)), rng)
    assert set(params) == set(tlayer.init_params(
        torch.Generator().manual_seed(0), it.recurrent(f, t)))
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    m = _mask("padded" if mask == "dropout" else mask, b, t)
    key = jax.random.PRNGKey(5)
    train = dropout is not None

    def jfn(p, xx):
        return jlayer.apply(p, xx, state={}, train=train, rng=key,
                            mask=None if m is None else jnp.asarray(m))[0]

    jout = jfn({k: jnp.asarray(v) for k, v in params.items()},
               jnp.asarray(x))
    w = rng.standard_normal(jout.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx) * w),
                        argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    tout, _ = tlayer.apply(tp, tx, state={}, train=train,
                           mask=None if m is None else torch.from_numpy(m),
                           rng=JaxKeys(key) if train else None)
    assert _rel(tout.detach().numpy(), jout) <= 1e-5
    (tout * torch.from_numpy(w)).sum().backward()
    assert _rel(tx.grad.numpy(), jgx) <= 1e-5
    for k in params:
        assert _rel(tp[k].grad.numpy(), jgp[k]) <= 1e-5, k
    if mask == "dead-row" and name != "LastTimeStep":
        assert not tout[1].detach().any()  # a masked step outputs zeros


@pytest.mark.parametrize("name", ["GravesBidirectionalLSTM", "SimpleRnn"])
def test_scan_carries_as_jax(name):
    """`scan` from a nonzero carry: the output and the carry out, nested
    for the bidirectional layer, whose backward half starts from zeros
    whatever it is given."""
    rng = np.random.default_rng(3)
    tlayer, jlayer = _layer_pair(name)
    params = _nonzero(jlayer.init_params(jax.random.PRNGKey(2),
                                         jit.recurrent(4, 6)), rng)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    m = _mask("padded", 3, 6)
    jcarry = jax.tree_util.tree_map(
        lambda c: jnp.asarray(rng.standard_normal(c.shape), jnp.float32),
        jlayer.init_carry(3))
    tcarry = jax.tree_util.tree_map(lambda c: torch.from_numpy(np.array(c)),
                                    jcarry)
    jy, jc = jlayer.scan({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), jcarry, mask=jnp.asarray(m))
    ty, tc = tlayer.scan({k: torch.tensor(v) for k, v in params.items()},
                         torch.from_numpy(x), tcarry,
                         mask=torch.from_numpy(m))
    assert _rel(ty.numpy(), jy) <= 1e-5
    jl_, tl_ = jax.tree_util.tree_leaves(jc), jax.tree_util.tree_leaves(tc)
    assert len(jl_) == len(tl_) == (4 if name != "SimpleRnn" else 1)
    for a, b in zip(tl_, jl_):
        assert _rel(a.numpy(), b) <= 1e-5


@pytest.mark.parametrize("mask", ["padded", "dead-row"])
@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
def test_masked_global_pooling_matches_jax(ptype, mask):
    """Over the live steps of [b, t, f], forward and gradient; a row with
    no live step gives -inf (max) or 0 (the others) and takes no gradient,
    but for pnorm, whose gradient there is NaN (0 ** (1 / p)), as in the
    JAX package."""
    rng = np.random.default_rng(len(ptype) + len(mask))
    cfg = dict(pooling_type=ptype, pnorm=3)
    t, j = tl.GlobalPooling(**cfg), jl.GlobalPooling(**cfg)
    x = rng.standard_normal((4, 6, 3)).astype(np.float32)
    m = _mask(mask, 4, 6)
    jfn = lambda xx: j.apply({}, xx, state={}, train=False, rng=None,  # noqa: E731
                             mask=jnp.asarray(m))[0]
    jout = np.asarray(jfn(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    tout = t.apply({}, tx, state={}, train=False,
                   mask=torch.from_numpy(m))[0]
    fin = np.isfinite(jout)
    np.testing.assert_array_equal(np.isfinite(tout.detach().numpy()), fin)
    assert _rel(tout.detach().numpy()[fin], jout[fin]) <= 1e-5
    if mask == "dead-row":
        want = -np.inf if ptype == "max" else 0.0
        assert (tout.detach().numpy()[1] == want).all()
    w = np.where(fin, rng.standard_normal(jout.shape), 0).astype(np.float32)
    jg = jax.grad(lambda xx: jnp.sum(jnp.where(
        jnp.isfinite(jfn(xx)), jfn(xx) * w, 0.0)))(jnp.asarray(x))
    torch.where(torch.from_numpy(fin), tout * torch.from_numpy(w),
                torch.zeros(())).sum().backward()
    got, jg = tx.grad.numpy(), np.asarray(jg)
    nan = np.isnan(jg)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan.any() == (ptype == "pnorm" and mask == "dead-row")
    assert _rel(got[~nan], jg[~nan]) <= 1e-5
    assert t.propagate_mask(torch.from_numpy(m), None) is None


# --------------------------------------------------------------- vertices
def test_recurrent_vertices_match_jax():
    """LastTimeStepVertex (with its input's mask, and without) and
    DuplicateToTimeSeriesVertex: forward, gradients, output types, the
    mask they propagate and their JSON across both packages."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7, 3)).astype(np.float32)
    ff = rng.standard_normal((5, 3)).astype(np.float32)
    m = _mask("dead-row", 5, 7)
    cases = [
        ("LastTimeStepVertex", {"mask_input": "in"}, [x], [m]),
        ("LastTimeStepVertex", {}, [x], None),
        ("DuplicateToTimeSeriesVertex", {}, [ff, x], [None, m]),
    ]
    for name, kwargs, xs, masks in cases:
        tv, jv = getattr(tgv, name)(**kwargs), getattr(jgv, name)(**kwargs)
        tm = None if masks is None else [
            None if a is None else torch.from_numpy(a) for a in masks]
        jm = None if masks is None else [
            None if a is None else jnp.asarray(a) for a in masks]

        def jfn(*a):
            return jv.apply({}, list(a), state={}, train=False, rng=None,
                            masks=jm)[0]

        jout = jfn(*[jnp.asarray(a) for a in xs])
        w = rng.standard_normal(jout.shape).astype(np.float32)
        jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                      argnums=tuple(range(len(xs))))(
            *[jnp.asarray(a) for a in xs])
        tx = [torch.tensor(a, requires_grad=True) for a in xs]
        tout = tv.apply({}, tx, state={}, train=False, masks=tm)[0]
        assert _rel(tout.detach().numpy(), jout) <= 1e-6, name
        (tout * torch.from_numpy(w)).sum().backward()
        assert _rel(tx[0].grad.numpy(), jg[0]) <= 1e-6, name
        ttypes = [it.recurrent(3, 7)] if len(xs) == 1 else \
            [it.feed_forward(3), it.recurrent(3, 7)]
        jtypes = [jit.recurrent(3, 7)] if len(xs) == 1 else \
            [jit.feed_forward(3), jit.recurrent(3, 7)]
        assert tv.output_type(ttypes).to_json() == \
            jv.output_type(jtypes).to_json()
        tprop, jprop = tv.propagate_mask(tm, ttypes), \
            jv.propagate_mask(jm, jtypes)
        assert (tprop is None) == (jprop is None), name
        if tprop is not None:
            np.testing.assert_array_equal(tprop.numpy(), np.asarray(jprop))
        d = tv.to_json()
        assert d == jv.to_json()
        assert jgv.GraphVertex.from_json(json.loads(json.dumps(d))
                                         ).to_json() == d
        assert tgv.GraphVertex.from_json(json.loads(json.dumps(d))) == tv


def test_propagate_mask_through_merge_elementwise_and_layers():
    """The default rule (the first input mask that is not None), a
    LayerVertex handing the mask to its layer (GlobalPooling and
    LastTimeStep consume it), as in the JAX package."""
    m = np.ones((2, 4), np.float32)
    m[1, 2:] = 0
    tm, jm = torch.from_numpy(m), jnp.asarray(m)
    rec, ff = it.recurrent(3, 4), it.feed_forward(3)
    jrec = jit.recurrent(3, 4)
    cases = [
        (tgv.MergeVertex(), jgv.MergeVertex(), [None, 0], [rec, rec]),
        (tgv.ElementWiseVertex(op="add"), jgv.ElementWiseVertex(op="add"),
         [0, None], [rec, rec]),
        (tgv.ElementWiseVertex(op="max"), jgv.ElementWiseVertex(op="max"),
         [None, None], [rec, rec]),
        (tgv.LayerVertex(layer=tl.Dense(n_out=2)),
         jgv.LayerVertex(layer=jl.Dense(n_out=2)), [0], [rec]),
        (tgv.LayerVertex(layer=tl.GlobalPooling()),
         jgv.LayerVertex(layer=jl.GlobalPooling()), [0], [rec]),
        (tgv.LayerVertex(layer=tl.LastTimeStep()),
         jgv.LayerVertex(layer=jl.LastTimeStep()), [0], [ff]),
    ]
    for tv, jv, which, types in cases:
        got = tv.propagate_mask([None if w is None else tm for w in which],
                                types)
        want = jv.propagate_mask([None if w is None else jm for w in which],
                                 [jrec] * len(types))
        assert (got is None) == (want is None), type(tv).__name__
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------- graphs
def _jconf(tbptt=None, seed=3):
    kw = {} if tbptt is None else dict(backprop_type="tbptt",
                                       tbptt_fwd_length=tbptt)
    return JNNC(seed=seed, updater=jupd.RmsProp(learning_rate=1e-2),
                l2=1e-4, **kw).graph()


def _char_graph(t, tbptt=None, n=N):
    """train-cg-rnn's graph cut to n and VOCAB classes: in -> l0
    GravesLSTM -> l1 GravesLSTM -> out RnnOutput."""
    return (_jconf(tbptt).add_inputs("in")
            .add_layer("l0", jl.GravesLSTM(n_out=n, activation="tanh"), "in")
            .add_layer("l1", jl.GravesLSTM(n_out=n, activation="tanh"), "l0")
            .add_layer("out", jl.RnnOutput(n_out=VOCAB, loss="mcxent",
                                           activation="softmax"), "l1")
            .set_outputs("out").set_input_types(jit.recurrent(VOCAB, t)))


def _bidir_graph(t, tbptt=None, n=N):
    """train-bidir's graph cut to n and VOCAB classes: in -> bi
    GravesBidirectionalLSTM; last (LastTimeStepVertex) and pool
    (GlobalPooling avg) of bi -> merge -> out Output."""
    return (_jconf(tbptt).add_inputs("in")
            .add_layer("bi", jl.GravesBidirectionalLSTM(
                n_out=n, activation="tanh"), "in")
            .add_vertex("last", jgv.LastTimeStepVertex(mask_input="in"),
                        "bi")
            .add_layer("pool", jl.GlobalPooling(pooling_type="avg"), "bi")
            .add_vertex("merge", jgv.MergeVertex(), "last", "pool")
            .add_layer("out", jl.Output(n_out=VOCAB, loss="mcxent",
                                        activation="softmax"), "merge")
            .set_outputs("out").set_input_types(jit.recurrent(VOCAB, t)))


def _graph_pair(jconf, seed=2026):
    """A JAX graph with nonzero biases and peepholes and the port's graph
    read from its JSON, carrying its weights."""
    jnet = JCG(jconf).init()
    rng = np.random.default_rng(seed)
    params = {k: _nonzero(v, rng) for k, v in
              jax.tree_util.tree_map(np.asarray, jnet.params).items()}
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    assert tnet.conf.to_json() == jconf.to_json()
    interop.params_from_jax(tnet, params,
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _chars(b, t, seed):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (b, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :t]], eye[ids[:, 1:]]


class _Recorder(TrainingListener):
    """Per listener call: (iteration, score, param table, updater
    slots)."""

    def __init__(self, jax_side):
        self.jax_side = jax_side
        self.calls = []

    def iteration_done(self, net, iteration, score):
        if self.jax_side:
            table = {k: np.array(v) for k, v in net.get_param_table().items()}
            slots = {k: jax.tree_util.tree_map(np.array, s)
                     for k, s in net.opt_state.items()}
        else:
            table = net.get_param_table()
            slots = interop.opt_state_to_jax(net)
        flat = {f"{k}/{p}": np.asarray(v) for k, s in slots.items() if s
                for p, v in flat_items(s)}
        self.calls.append((iteration, score, table, flat))


def _same_runs(trec, jrec):
    assert [c[0] for c in trec.calls] == [c[0] for c in jrec.calls]
    for (i, ts, tt, tg), (_, js, jt, jg) in zip(trec.calls, jrec.calls):
        assert abs(ts - js) <= 1e-5 * abs(js), (i, ts, js)
        assert sorted(tt) == sorted(jt)
        for k in jt:
            assert np.abs(tt[k] - jt[k]).max() <= 1e-5, (i, k)
        assert sorted(tg) == sorted(jg)
        for k in jg:
            assert _rel(tg[k], jg[k]) <= 1e-4, (i, k)


def _fit_both(jnet, tnet, batches):
    jrec, trec = _Recorder(True), _Recorder(False)
    jnet.set_listeners(jrec)
    tnet.set_listeners(trec)
    for feats, labels, fms, lms in batches:
        jnet.fit(jds.MultiDataSet(feats, labels, fms, lms))
        tnet.fit(MultiDataSet(feats, labels, fms, lms))
    _same_runs(trec, jrec)
    return trec


@pytest.mark.parametrize("labels", ["3d", "2d"])
def test_masked_graph_fit_matches_jax(labels):
    """Whole-sequence BPTT under masks, 2 steps: the char graph with
    features and labels masks (3-D labels, one row wholly masked), and the
    bidirectional classifier with a features mask and per-sequence labels
    (the label mask falls back to none: the output's input carries no
    mask after LastTimeStep and pooling)."""
    t = 9
    rng = np.random.default_rng(11)
    if labels == "3d":
        jnet, tnet = _graph_pair(_char_graph(t))
    else:
        jnet, tnet = _graph_pair(_bidir_graph(t))
    batches = []
    for step in range(2):
        x, y = _chars(5, t, 20 + step)
        fm = _mask("dead-row" if labels == "3d" else "padded", 5, t)
        if labels == "3d":
            lm = fm.copy()
            lm[0, :2] = 0.0
            batches.append(([x], [y], [fm], [lm]))
        else:
            y2 = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, 5)]
            batches.append(([x], [y2], [fm], None))
    rec = _fit_both(jnet, tnet, batches)
    assert len(rec.calls) == 2
    x, _ = _chars(5, t, 30)
    assert _rel(tnet.output(x).numpy(), jnet.output(x)) <= 1e-5
    mds = batches[0]
    assert abs(tnet.score(MultiDataSet(*mds)) - jnet.score(
        jds.MultiDataSet(*mds))) <= 1e-5 * abs(jnet.score(
            jds.MultiDataSet(*mds)))


@pytest.mark.parametrize("graph", ["char", "bidir"])
def test_graph_tbptt_with_masks_matches_jax_window_by_window(graph):
    """t = 20 in windows of 5, 2 batches of 4 rows: rows live for 20, 9,
    13 and 3 steps, so the last windows hold partly and wholly masked rows.
    Every window's score, listener call, params and slots against the JAX
    graph's; the bidirectional graph's labels are 3-D here (an RnnOutput
    on the sum of both halves), so it windows too, its backward half
    restarting in every window."""
    t = 20
    if graph == "char":
        jconf = _char_graph(t, tbptt=5)
    else:
        jconf = (_jconf(5).add_inputs("in")
                 .add_layer("bi", jl.GravesBidirectionalLSTM(
                     n_out=N, activation="tanh"), "in")
                 .add_layer("out", jl.RnnOutput(n_out=VOCAB, loss="mcxent",
                                                activation="softmax"), "bi")
                 .set_outputs("out").set_input_types(
                     jit.recurrent(VOCAB, t)))
    jnet, tnet = _graph_pair(jconf)
    fm = (np.arange(t)[None] < np.array([20, 9, 13, 3])[:, None]).astype(
        np.float32)
    batches = [([x], [y], [fm], [fm]) for x, y in
               (_chars(4, t, 40 + s) for s in range(2))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = _fit_both(jnet, tnet, batches)
    assert [c[0] for c in rec.calls] == list(range(1, 9))
    assert tnet.iteration == jnet.iteration == 8
    assert tnet.last_batch_size == jnet.last_batch_size == 4


def test_graph_tbptt_window_carries_reach_the_next_window():
    """The second window starts from the first's carries: the same window
    fed from zero carries scores differently; a 2-D label trains the whole
    sequence in one step under the same tBPTT config."""
    _, tnet = _graph_pair(_char_graph(10, tbptt=5))
    _, fresh = _graph_pair(_char_graph(10, tbptt=5))
    x, y = _chars(3, 10, 50)
    scores = []
    tnet.set_listeners(type("L", (), {"iteration_done": lambda s, n, i, sc:
                                      scores.append(sc)})())
    tnet.fit(MultiDataSet([x], [y]))
    fresh.fit(MultiDataSet([x[:, :5]], [y[:, :5]]))
    assert scores[0] == pytest.approx(fresh.score_, rel=1e-6)
    fresh.fit(MultiDataSet([x[:, 5:]], [y[:, 5:]]))
    assert abs(fresh.score_ - scores[1]) > 1e-4 * abs(scores[1])
    _, bidir = _graph_pair(_bidir_graph(10, tbptt=5))
    bidir.fit(MultiDataSet([x], [y[:, -1]]))
    assert bidir.iteration == 1


def test_seq2seq_encoder_decoder_graph_matches_jax():
    """The JAX package's seq2seq graph (tests/test_computation_graph.py):
    encoder LSTM -> LastTimeStepVertex -> DuplicateToTimeSeriesVertex over
    the decoder's timeline -> merged with the decoder input -> decoder
    LSTM -> RnnOutput; 3 steps with an encoder features mask (the last
    step by its live length) and a decoder mask, which the labels take."""
    jconf = (JNNC(seed=5, updater=jupd.Adam(learning_rate=1e-2)).graph()
             .add_inputs("encIn", "decIn")
             .add_layer("enc", jl.LSTM(n_out=8), "encIn")
             .add_vertex("lastStep", jgv.LastTimeStepVertex(), "enc")
             .add_vertex("dup", jgv.DuplicateToTimeSeriesVertex(),
                         "lastStep", "decIn")
             .add_vertex("decMerge", jgv.MergeVertex(), "decIn", "dup")
             .add_layer("dec", jl.LSTM(n_out=8), "decMerge")
             .add_layer("out", jl.RnnOutput(n_out=4, loss="mcxent"), "dec")
             .set_outputs("out")
             .set_input_types(jit.recurrent(5, 7), jit.recurrent(4, 6)))
    jnet, tnet = _graph_pair(jconf)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        enc = rng.standard_normal((3, 7, 5)).astype(np.float32)
        dec = rng.standard_normal((3, 6, 4)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 6))]
        em = (np.arange(7)[None] < np.array([[7], [4], [2]])).astype(
            np.float32)
        dm = (np.arange(6)[None] < np.array([[6], [6], [3]])).astype(
            np.float32)
        batches.append(([enc, dec], [y], [em, dm], None))
    _fit_both(jnet, tnet, batches)
    enc, dec = batches[0][0]
    assert _rel(tnet.output(enc, dec).numpy(), jnet.output(enc, dec)) <= 1e-5


def _bidir_mln_confs(tbptt=None):
    kw = {} if tbptt is None else dict(backprop_type="tbptt",
                                       tbptt_fwd_length=tbptt)
    return JNNC(seed=3, **kw).list([
        jl.GravesBidirectionalLSTM(n_out=6, activation="tanh"),
        jl.RnnOutput(n_out=VOCAB, loss="mcxent"),
    ]).set_input_type(jit.recurrent(VOCAB, 10))


def test_bidirectional_tbptt_warns_once_in_both_runtimes():
    """Both runtimes train a bidirectional layer by tBPTT with one warning
    per network, as the JAX package does; the MLN's nested carries pass
    from window to window detached, window by window as JAX's."""
    x, y = _chars(3, 10, 60)
    jconf = _bidir_mln_confs(tbptt=5)
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    for net, ds in ((jnet, jds.DataSet), (tnet, DataSet)):
        with pytest.warns(UserWarning, match="bidirectional"):
            net.fit(ds(x, y))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            net.fit(ds(x, y))
    assert tnet.iteration == jnet.iteration == 4
    jt = jnet.get_param_table()
    for k, v in tnet.get_param_table().items():
        assert np.abs(v - np.asarray(jt[k])).max() <= 1e-5, k
    _, graph = _graph_pair((_jconf(5).add_inputs("in")
                            .add_layer("bi", jl.GravesBidirectionalLSTM(
                                n_out=6, activation="tanh"), "in")
                            .add_layer("out", jl.RnnOutput(
                                n_out=VOCAB, loss="mcxent"), "bi")
                            .set_outputs("out")
                            .set_input_types(jit.recurrent(VOCAB, 10))))
    with pytest.warns(UserWarning, match=r"\['bi'\]"):
        graph.fit(MultiDataSet([x], [y]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        graph.fit(MultiDataSet([x], [y]))


def test_rnn_time_step_refusals():
    """rnn_time_step refuses a bidirectional layer (both runtimes), and the
    graph refuses a LastTimeStep around a recurrent layer for streaming
    and for tBPTT, as the JAX graph does; a recurrent layer followed by a
    LastTimeStepVertex streams."""
    x, y = _chars(2, 10, 70)
    mln = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _bidir_mln_confs().to_json())).init(device="cpu")
    with pytest.raises(ValueError, match="bidirectional"):
        mln.rnn_time_step(x)
    _, graph = _graph_pair(_bidir_graph(10))
    with pytest.raises(ValueError, match="bidirectional"):
        graph.rnn_time_step(x)
    wrapped = (_jconf(5).add_inputs("in")
               .add_layer("last", jl.LastTimeStep(underlying=jl.GravesLSTM(
                   n_out=6, activation="tanh")), "in")
               .add_layer("out", jl.Output(n_out=VOCAB, loss="mcxent"),
                          "last")
               .set_outputs("out").set_input_types(jit.recurrent(VOCAB, 10)))
    jnet, tnet = _graph_pair(wrapped)
    for net, mds in ((jnet, jds.MultiDataSet), (tnet, MultiDataSet)):
        with pytest.raises(ValueError, match="LastTimeStep"):
            net.rnn_time_step(x)
        with pytest.raises(ValueError, match="LastTimeStep"):
            net.fit(mds([x], [y]))  # 3-D labels: tBPTT windows
        assert net.iteration == 0
    # 2-D labels: the whole sequence in one step, no carries needed
    tnet.fit(MultiDataSet([x], [y[:, -1]]))
    jnet.fit(jds.MultiDataSet([x], [y[:, -1]]))
    assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    seq = (_jconf().add_inputs("in")
           .add_layer("l", jl.GravesLSTM(n_out=6, activation="tanh"), "in")
           .add_vertex("last", jgv.LastTimeStepVertex(), "l")
           .add_layer("out", jl.Output(n_out=VOCAB, loss="mcxent"), "last")
           .set_outputs("out").set_input_types(jit.recurrent(VOCAB, 10)))
    _, tnet = _graph_pair(seq)
    whole = tnet.output(x).numpy()
    tnet.rnn_time_step(x[:, :6])
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, 6:]).numpy(), whole,
                               atol=1e-6)


def test_char_graph_trains_as_the_mln():
    """train-cg-rnn's graph cut to n = 16 and 11 classes, tBPTT windows of
    5 over 3 x 15 masked characters (row 2 wholly masked in the last
    window), against the port's own MLN TextGenerationLSTM with the same
    weights: the same step, window by window."""
    t = 15
    jnet, graph = _graph_pair(_char_graph(t, tbptt=5))
    conf = TextGenerationLSTM(num_classes=VOCAB, max_length=t,
                              seed=3).conf()
    for layer in conf.layers[:2]:
        layer.n_out = N
    conf.defaults.backprop_type = "tbptt"
    conf.defaults.tbptt_fwd_length = 5
    mln = MultiLayerNetwork(conf).init(device="cpu")
    names = {"l0": "layer_0", "l1": "layer_1", "out": "layer_2"}
    interop.params_from_jax(mln, {names[k]: {p: np.asarray(v) for p, v in
                                             jnet.params[k].items()}
                                  for k in names},
                            {v: {} for v in names.values()})
    fm = (np.arange(t)[None] < np.array([[15], [12], [8]])).astype(
        np.float32)
    gs, ms = [], []
    graph.set_listeners(type("L", (), {"iteration_done": lambda s, n, i, sc:
                                       gs.append(sc)})())
    mln.set_listeners(type("L", (), {"iteration_done": lambda s, n, i, sc:
                                     ms.append(sc)})())
    for step in range(2):
        x, y = _chars(3, t, 80 + step)
        graph.fit(MultiDataSet([x], [y], [fm], [fm]))
        mln.fit(DataSet(x, y, fm, fm))
    assert len(gs) == len(ms) == 6
    np.testing.assert_allclose(gs, ms, rtol=1e-5)
    gt = graph.get_param_table()
    for k, name in names.items():
        for p, v in mln.get_param_table().items():
            if p.startswith(name + "/"):
                np.testing.assert_allclose(
                    gt[f"{k}/{p.split('/', 1)[1]}"], v, atol=1e-5)
