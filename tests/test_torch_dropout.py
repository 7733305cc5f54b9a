"""Dropout and weight noise in the port (nn/dropout.py, nn/weightnoise.py
and the runtimes that apply them) against the JAX package on the CPU.

torch cannot reproduce jax.random, so the parity tests replay the JAX
package's own keys into the port's draws (tests/torch_keys.py): the same
masks and noise reach both packages. The port's own draws (one
torch.Generator per network) are held to the distributions instead.

Tolerances: a transform of the same mask or noise, 1e-6 of max(1, |x|) in
float32 (the schedules' values are float64 here and float32 in JAX) and
bit for bit in bfloat16; fit against the JAX package's fit, scores 1e-5
relative, params 1e-5 absolute, updater slots 1e-4 of each leaf's largest
magnitude; under the mixed policy scores 1e-2 and each param's change
0.2 of JAX's in L2 norm (test_torch_training.py's mixed-precision bounds);
the port's own draws, 5 standard errors of the sampled statistic.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import dropout as jdrop
from deeplearning4j_tpu.nn import schedules as jsched
from deeplearning4j_tpu.nn import weightnoise as jwn
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu.nn.layers.base import iteration_scope as jscope
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import dropout as tdrop
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import schedules as tsched
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn import weightnoise as twn
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    Conv2D,
    Dense,
    DropoutLayer,
    GravesLSTM,
    Output,
    RnnOutput,
    Subsampling2D,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, iteration_scope
from deeplearning4j_tpu_torch.ops import xent_kernel as xk
from torch_keys import JaxKeys

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}

SCHEDULES = [
    {"type": "MapSchedule", "schedule": {"100": 0.9, "1000": 1.0}},
    {"type": "ExponentialSchedule", "decay_rate": 0.99},
    {"type": "StepSchedule", "decay_rate": 0.1, "step_size": 100},
]

DROPOUTS = {
    "dropout": {"type": "Dropout", "p": 0.7},
    "dropout_scheduled": {"type": "Dropout", "p": 0.8,
                          "p_schedule": SCHEDULES[1]},
    "alpha": {"type": "AlphaDropout", "p": 0.85},
    "gaussian_dropout": {"type": "GaussianDropout", "rate": 0.3},
    "gaussian_noise": {"type": "GaussianNoise", "stddev": 0.2,
                       "stddev_schedule": SCHEDULES[2]},
}

WEIGHT_NOISES = {
    "dropconnect": {"type": "DropConnect", "p": 0.8},
    "dropconnect_biases": {"type": "DropConnect", "p": 0.9,
                           "apply_to_biases": True,
                           "p_schedule": SCHEDULES[0]},
    "additive": {"type": "WeightNoise", "mean": 0.0, "stddev": 0.05},
    "multiplicative": {"type": "WeightNoise", "mean": 1.0, "stddev": 0.1,
                       "additive": False},
}


def _np(t):
    return t.detach().float().cpu().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------- transforms
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(DROPOUTS))
def test_dropout_of_jax_masks_equals_jax(kind, dname):
    """The port's transform of the JAX package's own mask or noise (same
    key) equals JAX's `apply`, at an iteration its schedule moves."""
    npd, jd, td = DTYPES[dname]
    x = np.random.default_rng(1).standard_normal((64, 33)).astype(
        np.float32).astype(npd)
    key = jax.random.PRNGKey(11)
    d = DROPOUTS[kind]
    want = jdrop.from_json(json.loads(json.dumps(d))).apply(
        jnp.asarray(x, jd), key, iteration=150)
    tx = torch.from_numpy(x.astype(np.float32)).to(td)
    got = tdrop.from_json(json.loads(json.dumps(d))).apply(
        tx, JaxKeys(key), iteration=150)
    assert got.dtype == td and got.shape == tx.shape
    w = _jnp(want)
    if dname == "bfloat16":
        np.testing.assert_array_equal(_np(got), w)
    else:
        assert np.abs(_np(got) - w).max() <= 1e-6 * max(1.0,
                                                        np.abs(w).max())


@pytest.mark.parametrize("kind", sorted(WEIGHT_NOISES))
@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_weight_noise_of_jax_draws_equals_jax(kind, layer):
    """`maybe_transform` on a layer's params with the JAX keys: the same
    noisy params as JAX's, in the interchange layout (a Conv2D kernel is
    drawn HWIO and held OIHW), and nothing at inference."""
    cfg = {"type": "Dense", "n_out": 6} if layer == "dense" else {
        "type": "Conv2D", "kernel_size": [3, 3], "n_out": 5,
        "convolution_mode": "same"}
    cfg["weight_noise"] = WEIGHT_NOISES[kind]
    jl = JLayer.from_json(cfg)
    tl = Layer.from_json(json.loads(json.dumps(cfg)))
    assert tl.to_json() == jl.to_json()
    from deeplearning4j_tpu.nn import inputs as jit_

    jin = (jit_.feed_forward(7) if layer == "dense"
           else jit_.convolutional(6, 6, 4))
    jp = jl.init_params(jax.random.PRNGKey(0), jin)
    jp = {k: v + 0.1 for k, v in jp.items()}  # non-zero biases
    tp = {k: tl.from_interchange(k, torch.from_numpy(np.array(v)))
          for k, v in jp.items()}
    key = jax.random.PRNGKey(5)
    with jscope(3):
        want = jwn.maybe_transform(jl, jp, key, True)
    with iteration_scope(3):
        got = twn.maybe_transform(tl, tp, JaxKeys(key), True)
    assert set(got) == set(want)
    for k in want:
        g = tl.to_interchange(k, got[k])
        w = np.asarray(want[k])
        assert np.abs(_np(g) - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), k
    if layer == "conv":
        assert got["W"].is_contiguous(memory_format=torch.channels_last)
    assert twn.maybe_transform(tl, tp, JaxKeys(key), False) is tp
    assert all(torch.equal(tp[k], tl.from_interchange(
        k, torch.from_numpy(np.array(jp[k])))) for k in tp)


# ---------------------------------------------------------- own draws
N_DRAW = 200_000


def _five_sigma(got, want, sigma):
    assert abs(got - want) <= 5 * sigma, (got, want, sigma)


@pytest.mark.parametrize("p", [0.5, 0.8, 0.95])
def test_own_dropout_keeps_p_and_scales_by_one_over_p(p):
    draws = tdrop.Draws.seeded(3, "cpu")
    y = tdrop.Dropout(p).apply(torch.ones(N_DRAW), draws)
    kept = y != 0
    _five_sigma(float(kept.float().mean()), p, (p * (1 - p) / N_DRAW) ** 0.5)
    assert torch.all(y[kept] == torch.tensor(1.0) / torch.tensor(p))
    mask = twn.DropConnect(p).apply(torch.full((N_DRAW,), 2.0), draws)
    _five_sigma(float((mask != 0).float().mean()), p,
                (p * (1 - p) / N_DRAW) ** 0.5)


def test_own_gaussian_draws_have_the_stated_moments():
    draws = tdrop.Draws.seeded(4, "cpu")
    rate = 0.3
    noise = tdrop.GaussianDropout(rate).apply(torch.ones(N_DRAW), draws)
    var = rate / (1 - rate)
    _five_sigma(float(noise.mean()), 1.0, (var / N_DRAW) ** 0.5)
    _five_sigma(float(noise.var()), var, var * (2 / N_DRAW) ** 0.5)
    add = tdrop.GaussianNoise(0.2).apply(torch.zeros(N_DRAW), draws)
    _five_sigma(float(add.var()), 0.04, 0.04 * (2 / N_DRAW) ** 0.5)
    wn = twn.WeightNoise(mean=1.0, stddev=0.1, additive=False).apply(
        torch.full((N_DRAW,), 3.0), draws)
    _five_sigma(float(wn.mean()), 3.0, 0.3 / N_DRAW ** 0.5)


def test_own_alpha_dropout_keeps_selu_activations_normalized():
    """SELU of N(0, 1) has mean 0 and variance 1; after AlphaDropout they
    stay so within 0.02."""
    g = torch.Generator().manual_seed(5)
    x = torch.nn.functional.selu(torch.randn(1_000_000, generator=g))
    for p in (0.5, 0.9):
        y = tdrop.AlphaDropout(p).apply(x, tdrop.Draws.seeded(6, "cpu"))
        assert abs(float(y.mean())) <= 0.02
        assert abs(float(y.var()) - 1.0) <= 0.02


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["type"])
def test_schedules_match_jax_scheduled(sched):
    js = jsched.from_json(json.loads(json.dumps(sched)))
    ts = tsched.from_json(json.loads(json.dumps(sched)))
    assert json.dumps(ts.to_json()) == json.dumps(js.to_json())
    for iteration in (0, 1, 100, 1000):
        want = float(jdrop.scheduled(0.8, js, iteration))
        got = tdrop.scheduled(0.8, ts, iteration)
        assert abs(got - want) <= 1e-6 * abs(want), (iteration, got, want)
    assert tdrop.scheduled(0.8, ts, None) == 0.8


def test_json_matches_jax_and_resolve_reads_floats():
    for d in list(DROPOUTS.values()) + list(WEIGHT_NOISES.values()):
        mod_t = tdrop if d["type"] in tdrop._DROPOUT_TYPES else twn
        mod_j = jdrop if mod_t is tdrop else jwn
        t = mod_t.from_json(json.loads(json.dumps(d)))
        j = mod_j.from_json(json.loads(json.dumps(d)))
        assert json.dumps(t.to_json()) == json.dumps(j.to_json())
        assert mod_t.from_json(t.to_json()) == t
    assert tdrop.resolve(0.7) == tdrop.Dropout(0.7)
    for v in (None, 0.0, 1.0, 1.5, -0.1):
        assert tdrop.resolve(v) is None
    assert twn.DropConnect(0.9).p == 0.9 and not twn.DropConnect(0.9).apply_to_biases


# ------------------------------------------------------------- training
def _conf(layers, in_type, seed=21, **defaults):
    return NeuralNetConfiguration(
        seed=seed, updater=defaults.pop("updater", updaters.Adam(
            learning_rate=1e-2)), **defaults).list(layers).set_input_type(
        in_type).to_json()


def _jax_table(jnet):
    flat = {}
    for key, v in jnet.get_param_table().items():
        v = v.item() if isinstance(v, np.ndarray) and v.dtype == object else v
        if isinstance(v, dict):
            for path, leaf in flat_items(v):
                flat[f"{key}/{path}"] = np.asarray(leaf)
        else:
            flat[key] = np.asarray(v)
    return flat


def _slots(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _slots(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _slots(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], np.asarray(tree)


def _assert_same_training(jnet, tnet, param_tol=1e-5, slot_tol=1e-4):
    jt, tt = _jax_table(jnet), tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        assert np.abs(tt[k] - jt[k]).max() <= param_tol, k
    want = dict(_slots(jax.tree_util.tree_map(np.asarray, jnet.opt_state)))
    got = dict(_slots(interop.opt_state_to_jax(tnet)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert np.abs(got[k] - w).max() <= slot_tol * max(
                float(np.abs(w).max()), 1e-30), k
    assert tnet.iteration == jnet.iteration


def mln_pair(conf_json):
    """A JAX network and a port network from one config JSON with the JAX
    weights, the port replaying the JAX network's keys."""
    jnet = JMLN(JConf.from_json(conf_json)).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json)
                             ).init(device="cpu")
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    tnet.draws = JaxKeys.for_net(tnet.conf.defaults.seed)
    return jnet, tnet


def fit_both(jnet, tnet, batches, score_tol=1e-5):
    from deeplearning4j_tpu.datasets import dataset as jds

    for x, y in batches:
        jnet.fit(jds.DataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert abs(tnet.score_ - jnet.score_) <= score_tol * abs(
            jnet.score_), (tnet.score_, jnet.score_)


def _ff_batches(n_in, n_out, steps=3, b=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, n_in)).astype(np.float32),
             np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, b)])
            for _ in range(steps)]


def _dense_case(kind):
    ff = it.feed_forward(5)
    if kind == "dense_dropout":
        return [Dense(n_out=8, activation="relu", dropout=0.7),
                Output(n_out=4, loss="mcxent")], ff
    if kind == "dropout_layer":
        return [Dense(n_out=8, activation="selu"),
                DropoutLayer(dropout=tdrop.AlphaDropout(p=0.8)),
                Dense(n_out=6, activation="tanh"),
                DropoutLayer(dropout=0.6),
                Output(n_out=4, loss="mcxent")], ff
    if kind == "gaussian":
        return [Dense(n_out=8, activation="relu",
                      dropout=tdrop.GaussianDropout(rate=0.2)),
                Dense(n_out=6, activation="tanh",
                      dropout=tdrop.GaussianNoise(stddev=0.1)),
                Output(n_out=4, loss="mcxent")], ff
    if kind == "weight_noise":
        return [Dense(n_out=8, activation="relu",
                      weight_noise=twn.WeightNoise(stddev=0.05)),
                Dense(n_out=6, activation="tanh",
                      weight_noise=twn.WeightNoise(mean=1.0, stddev=0.1,
                                                   additive=False,
                                                   apply_to_biases=True)),
                Output(n_out=4, loss="mcxent")], ff
    if kind == "scheduled":
        # StepSchedule(step 2) and MapSchedule{1: .6} move within 3 steps
        return [Dense(n_out=8, activation="relu",
                      dropout=tdrop.Dropout(
                          p=0.8, p_schedule=tsched.MapSchedule({1: 0.6})),
                      weight_noise=twn.DropConnect(
                          p=0.9,
                          p_schedule=tsched.ExponentialSchedule(0.9))),
                Dense(n_out=6, activation="tanh",
                      dropout=tdrop.GaussianNoise(
                          stddev=0.2, stddev_schedule=tsched.StepSchedule(
                              decay_rate=0.1, step_size=2))),
                Output(n_out=4, loss="mcxent")], ff
    if kind == "conv_dropconnect":
        return [Conv2D(kernel_size=(3, 3), n_out=4, convolution_mode="same",
                       activation="relu", dropout=0.9,
                       weight_noise=twn.DropConnect(0.8)),
                Subsampling2D(kernel_size=(2, 2), stride=(2, 2)),
                Dense(n_out=6, activation="tanh"),
                Output(n_out=3, loss="mcxent")], it.convolutional(6, 6, 2)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["dense_dropout", "dropout_layer",
                                  "gaussian", "weight_noise", "scheduled",
                                  "conv_dropconnect"])
def test_fit_with_replayed_masks_matches_jax(kind):
    layers, in_type = _dense_case(kind)
    jnet, tnet = mln_pair(_conf(layers, in_type))
    if kind == "conv_dropconnect":
        rng = np.random.default_rng(3)
        batches = [(rng.standard_normal((4, 6, 6, 2)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)])
                   for _ in range(3)]
    else:
        batches = _ff_batches(5, 4)
    fit_both(jnet, tnet, batches)
    _assert_same_training(jnet, tnet)


def test_dropconnect_output_layer_goes_through_linear_xent(monkeypatch):
    """A DropConnect Output: the noisy W (contiguous, float32) reaches the
    fused linear + softmax-xent route, whose gradient flows back through
    the mask to the raw param."""
    calls = []
    real = xk.linear_xent_rows

    def spy(x, w, b, labels):
        calls.append(w.is_contiguous())
        return real(x, w, b, labels)

    monkeypatch.setattr(xk, "linear_xent_rows", spy)
    jnet, tnet = mln_pair(_conf(
        [Dense(n_out=8, activation="relu"),
         Output(n_out=4, loss="mcxent",
                weight_noise=twn.DropConnect(0.7, apply_to_biases=True))],
        it.feed_forward(5)))
    fit_both(jnet, tnet, _ff_batches(5, 4))
    _assert_same_training(jnet, tnet)
    assert calls == [True] * 3


@pytest.mark.parametrize("tbptt", [False, True])
def test_lstm_fit_with_replayed_masks_matches_jax(tbptt):
    """An LSTM and a GravesLSTM with output dropout and DropConnect, an
    RnnOutput with DropConnect: by BPTT and by tBPTT (windows of 3 over
    7 steps, the output layer's weight noise left out as in JAX)."""
    extra = ({"backprop_type": "tbptt", "tbptt_fwd_length": 3,
              "tbptt_back_length": 3} if tbptt else {})
    layers = [LSTM(n_out=6, activation="tanh", dropout=0.8,
                   weight_noise=twn.DropConnect(0.9)),
              GravesLSTM(n_out=5, activation="tanh",
                         dropout=tdrop.GaussianNoise(0.1)),
              RnnOutput(n_out=4, loss="mcxent",
                        weight_noise=twn.DropConnect(0.8))]
    jnet, tnet = mln_pair(_conf(layers, it.recurrent(3, 7), **extra))
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((2, 7, 3)).astype(np.float32),
                np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 7))])
               for _ in range(2)]
    fit_both(jnet, tnet, batches)
    assert tnet.iteration == (6 if tbptt else 2)
    _assert_same_training(jnet, tnet)


def test_graph_fit_with_a_dropout_layer_vertex_matches_jax():
    """A ComputationGraph: a Dense with dropout, a DropoutLayer vertex, a
    merge and a DropConnect Output vertex; the draws follow the JAX
    package's topological order."""
    g = NeuralNetConfiguration(
        seed=8, updater=updaters.Nesterovs(learning_rate=0.05, momentum=0.9),
    ).graph().add_inputs("in")
    g.add_layer("d1", Dense(n_out=8, activation="relu", dropout=0.75), "in")
    g.add_layer("drop", DropoutLayer(dropout=tdrop.AlphaDropout(0.9)), "d1")
    g.add_layer("d2", Dense(n_out=6, activation="tanh",
                            weight_noise=twn.DropConnect(0.85)), "in")
    from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex

    g.add_vertex("cat", MergeVertex(), "drop", "d2")
    g.add_layer("out", Output(n_out=4, loss="mcxent",
                              weight_noise=twn.DropConnect(0.9)), "cat")
    g.set_outputs("out")
    g.set_input_types(it.feed_forward(5))
    conf_json = g.to_json()
    jnet = JCG(JGConf.from_json(conf_json)).init()
    tnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf_json)).init(device="cpu")
    assert tnet.topo == list(jnet.topo)
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    tnet.draws = JaxKeys.for_net(8)
    fit_both(jnet, tnet, _ff_batches(5, 4, seed=5))
    jt, tt = jnet.get_param_table(), tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        assert np.abs(tt[k] - np.asarray(jt[k])).max() <= 1e-5, k
    got = interop.opt_state_to_jax(tnet)
    for name, entry in jnet.opt_state.items():
        for path, w in flat_items(jax.tree_util.tree_map(np.asarray,
                                                         entry["v"])):
            g_ = dict(flat_items(got[name]["v"]))[path]
            assert np.abs(g_ - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                      1e-30), (name, path)


def test_mixed_precision_fit_with_replayed_masks_matches_jax():
    """Dropout in bfloat16 (x / p taken in bfloat16 in both packages),
    AlphaDropout's constants cast to bfloat16, DropConnect on float32
    params; 3 Nesterovs steps under the mixed policy."""
    layers = [Dense(n_out=16, activation="relu", dropout=0.7,
                    weight_noise=twn.DropConnect(0.9)),
              Dense(n_out=12, activation="selu",
                    dropout=tdrop.AlphaDropout(0.85)),
              Output(n_out=4, loss="mcxent")]
    conf = _conf(layers, it.feed_forward(5),
                 updater=updaters.Nesterovs(learning_rate=0.05,
                                            momentum=0.9))
    jnet, tnet = mln_pair(conf)
    start = tnet.get_param_table()
    with jdtypes.mixed(), tdtypes.mixed():
        fit_both(jnet, tnet, _ff_batches(5, 4, b=16), score_tol=1e-2)
    jt, tt = _jax_table(jnet), tnet.get_param_table()
    for k in jt:
        want, got = jt[k] - start[k], tt[k] - start[k]
        assert np.linalg.norm(want) > 0, k
        assert np.linalg.norm(got - want) <= 0.2 * np.linalg.norm(want), k


def test_fit_draws_from_the_network_seed_and_inference_never_draws():
    """The port's own draws: two networks of one seed train alike, another
    seed trains otherwise; output() and score() leave the generator
    alone; the dropout does act (a network without it ends elsewhere)."""
    def net(seed, dropout=0.6):
        layers = [Dense(n_out=16, activation="relu", dropout=dropout),
                  Output(n_out=4, loss="mcxent")]
        return MultiLayerNetwork(MultiLayerConfiguration.from_json(
            _conf(layers, it.feed_forward(5), seed=seed))).init(device="cpu")

    batches = _ff_batches(5, 4)
    nets = [net(1), net(1), net(2), net(1, dropout=None)]
    nets[2].params = {k: {n: t.clone() for n, t in p.items()}
                      for k, p in nets[0].params.items()}
    assert nets[0].draws.generator.device.type == "cpu"
    before = nets[0].draws.generator.get_state()
    nets[0].output(batches[0][0])
    nets[0].score(DataSet(*batches[0]))
    nets[0].score(DataSet(*batches[0]), training=True)
    assert torch.equal(nets[0].draws.generator.get_state(), before)
    for n in nets:
        for x, y in batches:
            n.fit(x, y)
    t = [n.get_param_table() for n in nets]
    assert all(np.array_equal(t[0][k], t[1][k]) for k in t[0])
    assert not np.array_equal(t[0]["layer_0/W"], t[2]["layer_0/W"])
    assert not np.array_equal(t[0]["layer_0/W"], t[3]["layer_0/W"])


# ------------------------------------------------------------------- zoo
@pytest.mark.parametrize("name", ["SimpleCNN", "AlexNet", "VGG16", "VGG19"])
def test_zoo_configs_equal_jax(name):
    want = json.loads(getattr(jzoo, name)().conf().to_json())
    got = json.loads(getattr(tzoo, name)().conf().to_json())
    assert got == want


def test_zoo_vgg16_full_width_params_and_a_step_as_jax():
    """VGG16's full-width count (224x224x3, 1000 classes: 138,357,544),
    then at 32x32x3 and 10 classes one Nesterovs step with the JAX keys
    equal to the JAX package's."""
    conf = tzoo.VGG16().conf()
    n = 0
    for layer, t in zip(conf.layers, conf.layer_input_types()):
        if isinstance(layer, Conv2D):
            n += 9 * t.channels * layer.n_out + layer.n_out
        elif isinstance(layer, Dense):
            n += (t.arity() + 1) * layer.n_out
    assert n == 138_357_544
    small = dict(num_classes=10, input_shape=(32, 32, 3))
    conf_json = tzoo.VGG16(**small).conf().to_json()
    assert conf_json == jzoo.VGG16(**small).conf().to_json()
    jnet, tnet = mln_pair(conf_json)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 2)]
    fit_both(jnet, tnet, [(x, y)])
    _assert_same_training(jnet, tnet)
