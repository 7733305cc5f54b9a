"""The line-search solvers of the port (deeplearning4j_tpu_torch/optimize/
solvers.py) and MultiLayerNetwork's solver path against the JAX package.

The solvers alone: `backtrack_line_search` and each optimizer's iterations
on a quadratic and on a Rosenbrock-like function, iteration by iteration
from the same point (the accepted alpha, the direction's norm, the pre-
and post-step scores within 1e-6 relative, the new point within 1e-6),
and the flat vector's order against `ravel_pytree`. The networks: fit with
each algorithm on Dense + Output (5 calls, params within 1e-5), a frozen
layer, BatchNorm's running state refreshed after the step, a GravesLSTM
char-RNN by BPTT, dropout with the JAX keys replayed (and, with the port's
own generator, the same masks in every evaluation of an iteration), tBPTT
taking the SGD step with the JAX warning, and a ComputationGraph training
with SGD as the JAX graph does. Weights are the JAX network's, carried
over with `interop.params_from_jax`; data from numpy with a seed; JAX runs
in float32 on the CPU.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.dropout import Draws
from deeplearning4j_tpu_torch.nn.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNorm,
    Dense,
    GravesLSTM,
    Output,
    RnnOutput,
)
from deeplearning4j_tpu_torch.nn.layers.misc import Frozen
from deeplearning4j_tpu_torch.optimize import solvers as tsolvers
from tests.torch_keys import JaxKeys

ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent", "sgd"]


# ---------------------------------------------------------------- functions
def _quadratic():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    a = (a @ a.T + np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)

    def jf(p):
        x = jnp.concatenate([p["a"], p["b"]])
        return 0.5 * x @ jnp.asarray(a) @ x - jnp.asarray(b) @ x

    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def tf(p):
        x = torch.cat([p["a"], p["b"]])
        return 0.5 * x @ ta @ x - tb @ x

    p0 = {"a": rng.standard_normal(3).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    return jf, tf, p0


def _rosenbrock():
    def jf(p):
        x = jnp.concatenate([p["a"], p["b"]])
        return jnp.sum(10.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    def tf(p):
        x = torch.cat([p["a"], p["b"]])
        return torch.sum(10.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1.0 - x[:-1]) ** 2)

    p0 = {"a": np.array([-0.5, 0.3], np.float32),
          "b": np.array([0.8, -0.2], np.float32)}
    return jf, tf, p0


FUNCTIONS = {"quadratic": _quadratic, "rosenbrock": _rosenbrock}


def _jvag(jf):
    return lambda p: jax.value_and_grad(jf)(p)


def _tvag(tf):
    def vag(p):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            s = tf(leaves)
            grads = torch.autograd.grad(s, list(leaves.values()))
        return s.detach(), dict(zip(leaves, grads))
    return vag


def _close(got, want, tol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(1.0, abs(want)), (what, got, want)


# ---------------------------------------------------------------- solvers
@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
def test_backtrack_line_search_matches_jax(fn):
    """From the start and along -g (and along +g, which is no descent: no
    step), the accepted alpha equals JAX's; the port counts its trials."""
    jf, tf, p0 = FUNCTIONS[fn]()
    v = np.concatenate([p0["a"], p0["b"]])
    jscore = lambda x: jf({"a": x[:2] if fn == "rosenbrock" else x[:3],
                            "b": x[2:] if fn == "rosenbrock" else x[3:]})
    cut = 2 if fn == "rosenbrock" else 3
    tscore = lambda x: tf({"a": x[:cut], "b": x[cut:]})
    jx = jnp.asarray(v)
    g = np.asarray(jax.grad(jscore)(jx))
    for sign in (-1.0, 1.0):
        d = (sign * g).astype(np.float32)
        slope = np.float32(np.dot(d, g))
        for max_it in (1, 5, 30):
            ja = float(jsolvers.backtrack_line_search(
                jscore, jx, jnp.asarray(d), jscore(jx), jnp.asarray(slope),
                max_it))
            tx = torch.from_numpy(v)
            ta, trials = tsolvers.backtrack_line_search(
                tscore, tx, torch.from_numpy(d), tscore(tx),
                torch.tensor(slope), max_it)
            assert abs(ta - ja) <= 1e-6 * max(1.0, abs(ja)), (sign, max_it,
                                                              ta, ja)
            assert 1 <= trials <= max_it
            if sign > 0:
                assert ta == 0.0


@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
@pytest.mark.parametrize("algo", ALGOS)
def test_optimizer_iterations_match_jax(fn, algo):
    """8 iterations from the same point: each iteration's alpha, direction
    norm, pre- and post-step scores and the new point against the JAX
    optimizer's jitted iteration, the solver state carried on both
    sides."""
    jf, tf, p0 = FUNCTIONS[fn]()
    jopt = jsolvers.Solver(algo, _jvag(jf), learning_rate=0.01).optimizer
    topt = tsolvers.Solver(algo, _tvag(tf), learning_rate=0.01).optimizer
    jv, junravel = ravel_pytree({k: jnp.asarray(v) for k, v in p0.items()})
    tv, tunravel = tsolvers.ravel({k: torch.from_numpy(v)
                                   for k, v in p0.items()})
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jstep = jopt._make_step(junravel, ())
    jst = jopt._init_solver_state(jv.size, jv.dtype)
    tst = topt._init_solver_state(tv.numel(), tv)
    for i in range(8):
        jv, jscore, _, jst, jextra = jstep(jv, jst)
        tv, tscore, _, tst, textra = topt._one_iter(tunravel, tv, tst, ())
        for k in ("alpha", "score0", "dir_norm", "grad_norm"):
            _close(textra[k], jextra[k], 1e-6 if k != "dir_norm" else 1e-5,
                   (i, k))
        _close(tscore, jscore, 1e-6, (i, "score"))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-6, err_msg=str(i))
        if algo != "sgd":
            assert 1 <= topt.last_trials <= topt.max_line_search_iterations
        # the next iteration starts from the same point on both sides
        tv = torch.from_numpy(np.asarray(jv).copy())


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_facade_optimize_matches_jax(algo):
    """Solver.optimize over 3 calls of 2 iterations (the solver state kept
    between calls, the host terminations): the same params and score."""
    jf, tf, p0 = _quadratic()
    js = jsolvers.Solver(algo, _jvag(jf), learning_rate=0.05)
    ts = tsolvers.Solver(algo, _tvag(tf), learning_rate=0.05)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    for _ in range(3):
        jp, jscore = js.optimize(jp, iterations=2)
        tp, tscore = ts.optimize(tp, iterations=2)
        _close(tscore, jscore, 1e-6, "score")
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, err_msg=k)
    assert ts.optimizer.iteration == js.optimizer.iteration
    with pytest.raises(ValueError, match="unknown optimization_algo"):
        tsolvers.Solver("newton", _tvag(tf))


def test_terminations_match_jax():
    extra = {"grad_norm": 1e-7, "dir_norm": 0.0}
    for jt, tt in ((jsolvers.EpsTermination(), tsolvers.EpsTermination()),
                   (jsolvers.Norm2Termination(), tsolvers.Norm2Termination()),
                   (jsolvers.ZeroDirection(), tsolvers.ZeroDirection())):
        for old, new in ((1.0, 1.0), (1.0, 0.5), (3.0, 2.99999)):
            assert bool(jt.terminate(old, new, extra)) == tt.terminate(
                old, new, extra)
        assert bool(jt.terminate(1.0, 0.5, {})) == tt.terminate(1.0, 0.5, {})
    v = torch.arange(4.0)
    for jcls, tcls in ((jsolvers.DefaultStepFunction,
                        tsolvers.DefaultStepFunction),
                       (jsolvers.NegativeDefaultStepFunction,
                        tsolvers.NegativeDefaultStepFunction),
                       (jsolvers.GradientStepFunction,
                        tsolvers.GradientStepFunction),
                       (jsolvers.NegativeGradientStepFunction,
                        tsolvers.NegativeGradientStepFunction)):
        want = np.asarray(jcls()(jnp.arange(4.0), jnp.ones(4), 0.5))
        np.testing.assert_array_equal(tcls()(v, torch.ones(4), 0.5).numpy(),
                                      want)


# ---------------------------------------------------------------- networks
def _dense_json(algo, seed=4, n_layers=1, dropout=None, frozen=False,
                bn=False, l2=0.0):
    layers = []
    if frozen:
        layers.append(Frozen(underlying=Dense(n_out=6, activation="tanh")))
    for _ in range(n_layers):
        layers.append(Dense(n_out=6, activation="tanh", dropout=dropout))
    if bn:
        layers.append(BatchNorm())
    layers.append(Output(n_out=3, loss="mcxent"))
    return NeuralNetConfiguration(
        seed=seed, updater=updaters.Sgd(learning_rate=0.1), l2=l2,
        optimization_algo=algo, max_num_line_search_iterations=5).list(
        layers).set_input_type(it.feed_forward(4)).to_json()


def _pair(conf_json, graph=False):
    if graph:
        jnet = JCG(JGConf.from_json(conf_json)).init()
        tnet = ComputationGraph(ComputationGraphConfiguration.from_json(
            conf_json)).init(device="cpu")
    else:
        jnet = JMLN(JConf.from_json(conf_json)).init()
        tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf_json)).init(device="cpu")
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _ff_batch(seed, n=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _assert_tables(jnet, tnet, tol):
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    tt = tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], atol=tol, err_msg=k)


def _fit_both(jnet, tnet, batches, score_tol=1e-5, iterations=None):
    for x, y, *masks in batches:
        fm, lm = (masks + [None, None])[:2]
        jnet.fit(jds.DataSet(x, y, fm, lm))
        tnet.fit(DataSet(x, y, fm, lm))
        assert abs(tnet.score_ - jnet.score_) <= score_tol * max(
            1.0, abs(jnet.score_)), (tnet.score_, jnet.score_)
    want = len(batches) if iterations is None else iterations
    assert tnet.iteration == jnet.iteration == want


def test_flat_vector_order_matches_ravel_pytree():
    """A network of 12 layers: "layer_10" and "layer_11" come before
    "layer_2" in both vectors, element by element."""
    jnet, tnet = _pair(_dense_json("lbfgs", n_layers=11))
    want, _ = ravel_pytree(jnet.params)
    got, unravel = tsolvers.ravel(tnet.params)
    assert unravel.paths.index("layer_10/W") < unravel.paths.index(
        "layer_2/W")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unravel(got)
    for k, p in tnet.params.items():
        for name, t in p.items():
            np.testing.assert_array_equal(back[k][name].numpy(), t.numpy())


@pytest.mark.parametrize("algo", ALGOS)
def test_mln_fit_with_each_algorithm_matches_jax(algo):
    """5 fit calls on 5 batches, one solver iteration each (the solver
    state carried across calls), l2 in the score: params within 1e-5."""
    jnet, tnet = _pair(_dense_json(algo, l2=1e-3))
    trials = []
    for s in range(5):
        _fit_both(jnet, tnet, [_ff_batch(s)], iterations=s + 1)
        if algo != "sgd":
            trials.append(tnet._solver.optimizer.last_trials)
    _assert_tables(jnet, tnet, 1e-5)
    if algo != "sgd":
        assert all(1 <= t <= 5 for t in trials), trials


def test_frozen_layer_and_batchnorm_refresh_match_jax():
    """A Frozen Dense first (left out of the optimized vector: unchanged)
    and a BatchNormalization whose running statistics one more training
    forward at the new params refreshes after each iteration."""
    jnet, tnet = _pair(_dense_json("lbfgs", frozen=True, bn=True))
    before = tnet.get_param_table()
    _fit_both(jnet, tnet, [_ff_batch(10 + s) for s in range(4)])
    _assert_tables(jnet, tnet, 1e-5)
    after = tnet.get_param_table()
    for k in before:
        if k.startswith("layer_0/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for k, st in jnet.state.items():
        for name, v in st.items():
            np.testing.assert_allclose(tnet.state[k][name].numpy(),
                                       np.asarray(v), atol=1e-5,
                                       err_msg=f"{k}/{name}")
    assert not np.array_equal(
        tnet.state["layer_2"]["mean"].numpy(), np.zeros(6, np.float32))


def _rnn_json(algo, tbptt=False):
    return NeuralNetConfiguration(
        seed=3, updater=updaters.RmsProp(learning_rate=1e-2),
        optimization_algo=algo, max_num_line_search_iterations=5,
        backprop_type="tbptt" if tbptt else "standard",
        tbptt_fwd_length=4, tbptt_back_length=4).list([
            GravesLSTM(n_out=8),
            RnnOutput(n_out=5, loss="mcxent")]).set_input_type(
        it.recurrent(5)).to_json()


def _seq_batch(seed, b=6, t=10):
    rng = np.random.default_rng(seed)
    eye = np.eye(5, dtype=np.float32)
    return eye[rng.integers(0, 5, (b, t))], eye[rng.integers(0, 5, (b, t))]


def test_graves_lstm_lbfgs_bptt_matches_jax():
    """A GravesLSTM char-RNN, standard BPTT (the plain scan on the CPU on
    both sides), 4 LBFGS iterations on 4 batches, one with a mask."""
    jnet, tnet = _pair(_rnn_json("lbfgs"))
    batches = [_seq_batch(s) for s in range(3)]
    x, y = _seq_batch(3)
    fm = np.ones(x.shape[:2], np.float32)
    fm[1, 6:] = 0.0
    batches.append((x, y, fm, fm))
    _fit_both(jnet, tnet, batches)
    _assert_tables(jnet, tnet, 1e-5)


def test_dropout_under_lbfgs_matches_jax_keys():
    """Dropout 0.7 on the Dense: the JAX keys replayed into the port's
    draws; every evaluation of an iteration (score, line-search trials,
    post-step) sees the iteration's one mask, as JAX's one `sub` key."""
    jnet, tnet = _pair(_dense_json("lbfgs", dropout=0.7))
    tnet.draws = JaxKeys.for_net(4)
    _fit_both(jnet, tnet, [_ff_batch(20 + s) for s in range(3)])
    _assert_tables(jnet, tnet, 1e-5)


class RecordingDraws(Draws):
    """The port's own generator, keeping every mask it draws."""

    def __init__(self, generator):
        super().__init__(generator)
        self.masks = []

    def bernoulli(self, p, shape):
        m = super().bernoulli(p, shape)
        self.masks.append(m.clone())
        return m


def test_solver_evaluations_share_one_mask():
    """With the port's `Draws`, each evaluation of one solver iteration
    draws the same mask (the generator is set back to the iteration's
    start), and the next iteration draws a new one."""
    _, tnet = _pair(_dense_json("lbfgs", dropout=0.5))
    tnet.draws = RecordingDraws(torch.Generator().manual_seed(5))
    x, y = _ff_batch(30)
    tnet.fit(DataSet(x, y))
    first = list(tnet.draws.masks)
    trials = tnet._solver.optimizer.last_trials
    assert len(first) == 2 + trials  # pre-step, trials, post-step
    assert all(torch.equal(m, first[0]) for m in first)
    tnet.fit(DataSet(x, y))
    second = tnet.draws.masks[len(first):]
    assert all(torch.equal(m, second[0]) for m in second)
    assert not torch.equal(second[0], first[0])


def test_tbptt_with_lbfgs_warns_and_trains_as_jax():
    """A tBPTT configuration naming LBFGS: both packages warn once and
    take the SGD updater step per window."""
    jnet, tnet = _pair(_rnn_json("lbfgs", tbptt=True))
    batches = [_seq_batch(40 + s) for s in range(2)]
    with pytest.warns(UserWarning, match="only honored by") as jw:
        jnet.fit(jds.DataSet(*batches[0]))
    with pytest.warns(UserWarning, match="only honored by") as tw:
        tnet.fit(DataSet(*batches[0]))
    assert len(tw) == 1 and str(tw[0].message) == str(jw[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per network
        tnet.fit(DataSet(*batches[1]))
    jnet.fit(jds.DataSet(*batches[1]))
    assert tnet.iteration == jnet.iteration == 6  # 3 windows per batch
    assert tnet._solver is None
    _assert_tables(jnet, tnet, 1e-5)


def test_computation_graph_with_lbfgs_trains_as_jax_graph():
    """The JAX graph has no solver path: with optimization_algo="lbfgs"
    it takes its SGD updater step, and so does the port's."""
    g = NeuralNetConfiguration(
        seed=6, optimization_algo="lbfgs",
        updater=updaters.Nesterovs(learning_rate=0.1, momentum=0.9)).graph()
    g.add_inputs("in")
    g.add_layer("d", Dense(n_out=7, activation="tanh"), "in")
    g.add_layer("out", Output(n_out=3, loss="mcxent"), "d")
    g.set_outputs("out")
    g.set_input_types(it.feed_forward(4))
    conf_json = g.to_json()
    assert json.loads(conf_json)["defaults"]["optimization_algo"] == "lbfgs"
    jnet, tnet = _pair(conf_json, graph=True)
    _fit_both(jnet, tnet, [_ff_batch(50 + s) for s in range(3)])
    _assert_tables(jnet, tnet, 1e-5)
