"""The evaluation slice against the JAX package: the evaluators (numpy
copies in the port) on identical numpy inputs, their JSON across the
packages, the networks' evaluate* family, predict, do_evaluation and
evaluate_outputs on the same weights, summary() and clone().

Tolerances: the evaluators get the same numpy arrays in both packages, so
every statistic must match exactly. At network level the port's and JAX's
probabilities differ at about 1e-6 (the same float32 operations, sums in
another order), so confusion matrices, ROC counts and predictions agree
only where no row's top two probabilities (and no probability and a
threshold) lie closer than that: each network test asserts a margin of
1e-4 between every row's top two probabilities on its inputs before it
compares argmax-based statistics, and compares probability-based ones
(AUC, calibration sums, regression errors) within 1e-5.
"""
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import eval as jeval
from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.eval import curves as jcurves
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu_torch import eval as teval
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.eval import curves as tcurves
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    Dense,
    GravesLSTM,
    Output,
    RnnOutput,
)

MARGIN = 1e-4


def _probs(rng, shape):
    z = rng.normal(0, 2, shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, shape):
    return np.eye(shape[-1], dtype=np.float32)[rng.integers(0, shape[-1],
                                                            shape[:-1])]


def _data(rng, kind, c=4):
    """(labels, predictions, mask): [40, c] rows, or [6, 9, c] steps with
    a right-padded [6, 9] mask (one row wholly masked)."""
    if kind == "2d":
        return _onehot(rng, (40, c)), _probs(rng, (40, c)), None
    y, p = _onehot(rng, (6, 9, c)), _probs(rng, (6, 9, c))
    mask = (np.arange(9)[None] < np.array([9, 5, 1, 7, 0, 9])[:, None])
    return y, p, mask.astype(np.float32)


def _halves(*arrays):
    return ([None if a is None else a[:len(a) // 2] for a in arrays],
            [None if a is None else a[len(a) // 2:] for a in arrays])


# ---------------------------------------------------------------- evaluators
def _evaluation_stats(ev):
    c = ev.num_classes
    return {
        "matrix": ev.confusion.matrix.tolist(), "total": ev.total,
        "accuracy": ev.accuracy(), "top_n": ev.top_n_accuracy(),
        "precision": ev.precision(), "recall": ev.recall(), "f1": ev.f1(),
        "per_class": [(ev.precision(i), ev.recall(i), ev.f1(i),
                       ev.matthews_correlation(i), ev.true_positives(i),
                       ev.false_positives(i), ev.false_negatives(i))
                      for i in range(c)],
        "stats": ev.stats(),
    }


@pytest.mark.parametrize("kind", ["2d", "3d_masked"])
@pytest.mark.parametrize("top_n", [1, 3])
def test_evaluation_matches_jax_exactly(rng, kind, top_n):
    y, p, m = _data(rng, kind)
    tev, jev = teval.Evaluation(top_n=top_n), jeval.Evaluation(top_n=top_n)
    tev.eval(y, p, mask=m)
    jev.eval(y, p, mask=m)
    assert _evaluation_stats(tev) == _evaluation_stats(jev)


@pytest.mark.parametrize("kind", ["2d", "3d_masked"])
def test_evaluation_merge_of_two_halves_matches_jax(rng, kind):
    y, p, m = _data(rng, kind)
    a, b = _halves(y, p, m)
    got = []
    for pkg in (teval, jeval):
        e1, e2 = pkg.Evaluation(top_n=2), pkg.Evaluation(top_n=2)
        e1.eval(*a[:2], mask=a[2])
        e2.eval(*b[:2], mask=b[2])
        got.append(_evaluation_stats(e1.merge(e2)))
    whole = teval.Evaluation(top_n=2)
    whole.eval(y, p, mask=m)
    assert got[0] == got[1] == _evaluation_stats(whole)


def _roc_stats(r):
    fpr, tpr = r.get_roc_curve()
    pr = r.precision_recall_curve()
    return (r.calculate_auc(), r.calculate_auprc(), list(map(float, fpr)),
            list(map(float, tpr)), pr.recall, pr.precision,
            r.roc_curve().area(), pr.area())


@pytest.mark.parametrize("steps", [0, 50])
@pytest.mark.parametrize("columns", [1, 2])
def test_roc_matches_jax_exactly(rng, steps, columns):
    """Exact and thresholded modes, a [n] score or [n, 2] one-hot columns,
    and the merge of two halves."""
    y2, p2 = _onehot(rng, (60, 2)), _probs(rng, (60, 2))
    y, p = (y2, p2) if columns == 2 else (y2[:, 1], p2[:, 1])
    (ya, pa), (yb, pb) = _halves(y, p)
    got = []
    for pkg in (teval, jeval):
        r = pkg.ROC(steps)
        r.eval(y, p)
        r1, r2 = pkg.ROC(steps), pkg.ROC(steps)
        r1.eval(ya, pa)
        r2.eval(yb, pb)
        got.append((_roc_stats(r), _roc_stats(r1.merge(r2))))
    assert got[0] == got[1]


@pytest.mark.parametrize("cls", ["ROCMultiClass", "ROCBinary"])
@pytest.mark.parametrize("steps", [0, 25])
def test_roc_per_column_matches_jax_exactly(rng, cls, steps):
    y, p = _onehot(rng, (5, 8, 3)), _probs(rng, (5, 8, 3))
    (ya, pa), (yb, pb) = _halves(y, p)
    got = []
    for pkg in (teval, jeval):
        r = getattr(pkg, cls)(steps)
        r.eval(y, p)
        r1, r2 = getattr(pkg, cls)(steps), getattr(pkg, cls)(steps)
        r1.eval(ya, pa)
        r2.eval(yb, pb)
        merged = r1.merge(r2)
        got.append(([r.calculate_auc(c) for c in range(3)],
                    r.calculate_average_auc(),
                    merged.calculate_average_auc(), r.is_empty()))
    assert got[0] == got[1]


def _regression_stats(ev):
    cols = range(ev.num_columns)
    return ([(ev.mean_squared_error(c), ev.mean_absolute_error(c),
              ev.root_mean_squared_error(c), ev.relative_squared_error(c),
              ev.pearson_correlation(c), ev.r_squared(c)) for c in cols],
            ev.average_mean_squared_error(),
            ev.average_mean_absolute_error(), ev.stats())


@pytest.mark.parametrize("kind", ["2d", "3d_masked"])
def test_regression_matches_jax_exactly(rng, kind):
    _, p, m = _data(rng, kind, c=3)
    y = (p + rng.normal(0, 0.3, p.shape)).astype(np.float32)
    a, b = _halves(y, p, m)
    got = []
    for pkg in (teval, jeval):
        ev = pkg.RegressionEvaluation()
        ev.eval(y, p, mask=m)
        e1, e2 = pkg.RegressionEvaluation(), pkg.RegressionEvaluation()
        e1.eval(*a[:2], mask=a[2])
        e2.eval(*b[:2], mask=b[2])
        got.append((_regression_stats(ev), _regression_stats(e1.merge(e2))))
    assert got[0] == got[1]


@pytest.mark.parametrize("masked", [False, True])
def test_evaluation_binary_matches_jax_exactly(rng, masked):
    y = (rng.random((30, 5)) < 0.4).astype(np.float32)
    p = rng.random((30, 5)).astype(np.float32)
    m = (rng.random((30, 5)) < 0.8).astype(np.float32) if masked else None
    a, b = _halves(y, p, m)
    got = []
    for pkg in (teval, jeval):
        ev = pkg.EvaluationBinary()
        ev.eval(y, p, mask=m)
        e1, e2 = pkg.EvaluationBinary(), pkg.EvaluationBinary()
        e1.eval(*a[:2], mask=a[2])
        e2.eval(*b[:2], mask=b[2])
        merged = e1.merge(e2)
        got.append(([(ev.accuracy(c), ev.precision(c), ev.recall(c),
                      ev.f1(c)) for c in range(5)], ev.average_accuracy(),
                    ev.average_f1(), ev.stats(), merged.stats()))
    assert got[0] == got[1]


@pytest.mark.parametrize("kind", ["2d", "3d_masked"])
def test_calibration_matches_jax_exactly(rng, kind):
    y, p, _ = _data(rng, kind)
    a, b = _halves(y, p)
    got = []
    for pkg in (teval, jeval):
        ev = pkg.EvaluationCalibration(reliability_bins=7, histogram_bins=11)
        ev.eval(y, p)
        e1 = pkg.EvaluationCalibration(7, 11)
        e2 = pkg.EvaluationCalibration(7, 11)
        e1.eval(*a)
        e2.eval(*b)
        e1.merge(e2)
        got.append((
            [(ev.reliability_diagram(c)[0].tolist(),
              ev.reliability_diagram(c)[1].tolist(),
              ev.expected_calibration_error(c),
              ev.get_reliability_diagram(c).to_json(),
              ev.get_probability_histogram(c).to_json(),
              ev.get_residual_histogram(c).to_json()) for c in range(4)],
            e1.bin_count.tolist(), e1.prob_hist.tolist(),
            e1.residual_hist.tolist()))
    assert got[0] == got[1]


# ---------------------------------------------------------------- JSON
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_evaluation_json_crosses_packages(rng, direction):
    y, p, m = _data(rng, "3d_masked")
    src, dst = (teval, jeval) if direction == "port_to_jax" else (jeval,
                                                                  teval)
    ev = src.Evaluation(top_n=2)
    ev.eval(y, p, mask=m)
    back = dst.Evaluation.from_json(ev.to_json())
    assert back.to_json() == ev.to_json()
    assert type(back).__module__.startswith(dst.__name__)
    assert back.stats() == ev.stats()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_curves_json_crosses_packages(rng, direction):
    src, dst = ((tcurves, jcurves) if direction == "port_to_jax"
                else (jcurves, tcurves))
    y, p = _onehot(rng, (50, 2)), _probs(rng, (50, 2))
    for steps in (0, 20):
        r = (teval if src is tcurves else jeval).ROC(steps)
        r.eval(y, p)
        for curve in (r.roc_curve(), r.precision_recall_curve()):
            d = json.loads(json.dumps(curve.to_json()))
            back = dst.BaseCurve.from_json(d)
            assert type(back).__name__ == type(curve).__name__
            assert back.to_json() == curve.to_json()
            assert back.area() == curve.area()
    hist = src.Histogram(title="h", lower=0.0, upper=2.0, counts=[1, 2, 3])
    back = dst.BaseCurve.from_json(hist.to_json())
    assert back.to_json() == hist.to_json()
    assert back.bin_edges().tolist() == hist.bin_edges().tolist()


# ---------------------------------------------------------------- networks
def _mln_json(kind):
    d = NeuralNetConfiguration(seed=5, updater=updaters.Adam(
        learning_rate=0.01))
    if kind == "ff":
        conf = d.list([Dense(n_out=12, activation="tanh"),
                       Output(n_out=4, loss="mcxent",
                              activation="softmax")]).set_input_type(
            it.feed_forward(6))
    else:
        conf = d.list([GravesLSTM(n_out=8),
                       RnnOutput(n_out=4, loss="mcxent",
                                 activation="softmax")]).set_input_type(
            it.recurrent(5))
    return conf.to_json()


def _mln_pair(kind):
    conf_json = _mln_json(kind)
    jnet = JMLN(JConf.from_json(conf_json)).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf_json)).init(device="cpu")
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _assert_margin(probs, mask=None):
    """The tie guard of the module docstring: every (live) row's top two
    probabilities at least MARGIN apart."""
    p = np.asarray(probs).reshape(-1, np.shape(probs)[-1])
    if mask is not None:
        p = p[np.asarray(mask).reshape(-1) > 0]
    top2 = np.sort(p, axis=-1)[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min()) >= MARGIN


def _ff_batches(rng, n=3, b=10):
    return [(rng.normal(0, 1.5, (b, 6)).astype(np.float32),
             _onehot(rng, (b, 4))) for _ in range(n)]


def _iters(batches):
    """A port and a JAX iterator over the same numpy batches."""
    tds = [DataSet(*b) for b in batches]
    jdss = [jds.DataSet(*b) for b in batches]
    return (lambda: iter(tds)), (lambda: iter(jdss))


def test_mln_evaluate_family_matches_jax(rng):
    jnet, tnet = _mln_pair("ff")
    batches = _ff_batches(rng)
    tit, jit_ = _iters(batches)
    xs = np.concatenate([x for x, _ in batches])
    _assert_margin(jnet.output(xs))
    np.testing.assert_array_equal(tnet.predict(xs), jnet.predict(xs))
    assert _evaluation_stats(tnet.evaluate(tit())) == _evaluation_stats(
        jnet.evaluate(jit_()))
    for fn, kw in (("evaluate_roc_multi_class", {"threshold_steps": 0}),
                   ("evaluate_roc_multi_class", {"threshold_steps": 20}),
                   ("evaluate_roc", {})):
        t = getattr(tnet, fn)(tit(), **kw)
        j = getattr(jnet, fn)(jit_(), **kw)
        if fn == "evaluate_roc":
            assert abs(t.calculate_auc() - j.calculate_auc()) <= 1e-5
        else:
            for c in range(4):
                assert abs(t.calculate_auc(c) - j.calculate_auc(c)) <= 1e-5
    treg, jreg = tnet.evaluate_regression(tit()), jnet.evaluate_regression(
        jit_())
    for c in range(4):
        assert abs(treg.mean_squared_error(c)
                   - jreg.mean_squared_error(c)) <= 1e-6
        assert abs(treg.r_squared(c) - jreg.r_squared(c)) <= 1e-5
    tcal = tnet.evaluate_calibration(tit(), reliability_bins=5,
                                     histogram_bins=8)
    jcal = jnet.evaluate_calibration(jit_(), reliability_bins=5,
                                     histogram_bins=8)
    assert tcal.bin_count.sum() == jcal.bin_count.sum() == 30 * 4
    np.testing.assert_allclose(tcal.bin_prob_sum, jcal.bin_prob_sum,
                               atol=1e-5)


def test_rnn_mln_evaluate_counts_live_steps_as_jax(rng):
    """[b, t, c] outputs under a right-padded labels mask: only the live
    steps are counted, in both packages."""
    jnet, tnet = _mln_pair("rnn")
    x = rng.normal(0, 1, (4, 7, 5)).astype(np.float32)
    y = _onehot(rng, (4, 7, 4))
    lm = (np.arange(7)[None] < np.array([7, 3, 0, 5])[:, None]).astype(
        np.float32)
    _assert_margin(jnet.output(x), lm)
    tev = tnet.evaluate([DataSet(x, y, None, lm)])
    jev = jnet.evaluate([jds.DataSet(x, y, None, lm)])
    assert tev.total == 15
    assert _evaluation_stats(tev) == _evaluation_stats(jev)
    out = tnet.output(x).numpy()
    live = lm.reshape(-1) > 0
    want = np.mean(out.reshape(-1, 4)[live].argmax(-1)
                   == y.reshape(-1, 4)[live].argmax(-1))
    assert tev.accuracy() == pytest.approx(want, abs=0)


def _graph_json(two_outputs):
    g = NeuralNetConfiguration(seed=9).graph().add_inputs("a", "b")
    g.add_layer("da", Dense(n_out=7, activation="relu"), "a")
    g.add_layer("db", Dense(n_out=7, activation="tanh"), "b")
    from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex

    g.add_vertex("m", MergeVertex(), "da", "db")
    g.add_layer("out", Output(n_out=3, loss="mcxent"), "m")
    outs = ["out"]
    if two_outputs:
        g.add_layer("out2", Output(n_out=5, loss="mcxent"), "db")
        outs.append("out2")
    g.set_outputs(*outs)
    g.set_input_types(it.feed_forward(4), it.feed_forward(3))
    return g.to_json()


def _graph_pair(two_outputs):
    conf_json = _graph_json(two_outputs)
    jnet = JCG(JGConf.from_json(conf_json)).init()
    tnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf_json)).init(device="cpu")
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _graph_batches(rng, two_outputs, n=3, b=8):
    out = []
    for _ in range(n):
        xs = [rng.normal(0, 2, (b, 4)).astype(np.float32),
              rng.normal(0, 2, (b, 3)).astype(np.float32)]
        ys = [_onehot(rng, (b, 3))] + ([_onehot(rng, (b, 5))]
                                       if two_outputs else [])
        out.append((xs, ys))
    return out


def test_graph_do_evaluation_matches_jax(rng):
    """One pass feeding three evaluators of a two-input, one-output graph,
    and the evaluate* family on it."""
    jnet, tnet = _graph_pair(False)
    batches = _graph_batches(rng, False)
    tm = [MultiDataSet(xs, ys) for xs, ys in batches]
    jm = [jds.MultiDataSet(xs, ys) for xs, ys in batches]
    for xs, _ in batches:
        _assert_margin(jnet.output(*xs))
    tevs = tnet.do_evaluation(tm, teval.Evaluation(), teval.ROCMultiClass(),
                              teval.EvaluationCalibration())
    jevs = jnet.do_evaluation(jm, jeval.Evaluation(), jeval.ROCMultiClass(),
                              jeval.EvaluationCalibration())
    assert _evaluation_stats(tevs[0]) == _evaluation_stats(jevs[0])
    assert abs(tevs[1].calculate_average_auc()
               - jevs[1].calculate_average_auc()) <= 1e-5
    assert tevs[2].bin_count.tolist() == jevs[2].bin_count.tolist()
    assert _evaluation_stats(tnet.evaluate(tm)) == _evaluation_stats(
        jnet.evaluate(jm))
    assert abs(tnet.evaluate_roc_multi_class(tm, 10).calculate_average_auc()
               - jnet.evaluate_roc_multi_class(jm, 10)
               .calculate_average_auc()) <= 1e-5
    assert abs(tnet.evaluate_regression(tm).average_mean_squared_error()
               - jnet.evaluate_regression(jm)
               .average_mean_squared_error()) <= 1e-6


def test_graph_evaluate_outputs_matches_jax(rng):
    """Each output of a two-output graph to its own evaluators, by name and
    by index; do_evaluation refuses the graph, as JAX's does."""
    jnet, tnet = _graph_pair(True)
    batches = _graph_batches(rng, True)
    tm = [MultiDataSet(xs, ys) for xs, ys in batches]
    jm = [jds.MultiDataSet(xs, ys) for xs, ys in batches]
    for xs, _ in batches:
        for o in jnet.output(*xs):
            _assert_margin(o)
    t = tnet.evaluate_outputs(tm, {"out": teval.Evaluation(),
                                   1: [teval.Evaluation(top_n=2),
                                       teval.ROCMultiClass()]})
    j = jnet.evaluate_outputs(jm, {"out": jeval.Evaluation(),
                                   1: [jeval.Evaluation(top_n=2),
                                       jeval.ROCMultiClass()]})
    assert _evaluation_stats(t["out"]) == _evaluation_stats(j["out"])
    assert _evaluation_stats(t[1][0]) == _evaluation_stats(j[1][0])
    assert abs(t[1][1].calculate_average_auc()
               - j[1][1].calculate_average_auc()) <= 1e-5
    with pytest.raises(ValueError, match="single-output"):
        tnet.do_evaluation(tm, teval.Evaluation())
    with pytest.raises(ValueError, match="no output"):
        tnet.evaluate_outputs(tm, {7: teval.Evaluation()})


def test_eval_over_copies_tensors_to_the_host(rng):
    """Labels and masks that are tensors (a batch already on the device)
    reach the evaluator as numpy; so does a bfloat16 output."""
    y, p, m = _data(rng, "3d_masked")
    ev = teval.Evaluation()
    feed = teval.mask_aware_feeder(ev)
    feed(torch.from_numpy(y), torch.from_numpy(p).bfloat16(),
         torch.from_numpy(m))
    want = teval.Evaluation()
    want.eval(y, torch.from_numpy(p).bfloat16().float().numpy(), mask=m)
    assert ev.to_json() == want.to_json()
    roc = teval.ROCMultiClass()
    teval.mask_aware_feeder(roc)(torch.from_numpy(y), torch.from_numpy(p),
                                 None)
    assert not roc.is_empty()


# ---------------------------------------------------------------- inspection
@pytest.mark.parametrize("kind", ["ff", "rnn", "graph", "graph2"])
def test_summary_text_equals_jax(kind):
    if kind.startswith("graph"):
        jnet, tnet = _graph_pair(kind == "graph2")
    else:
        jnet, tnet = _mln_pair(kind)
    assert tnet.summary() == jnet.summary()


def test_summary_of_an_uninitialized_network_equals_jax():
    conf_json = _mln_json("ff")
    t = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json))
    j = JMLN(JConf.from_json(conf_json))
    assert t.summary() == j.summary()


def test_clone_is_equal_and_independent(rng):
    _, net = _mln_pair("ff")
    x, y = _ff_batches(rng, n=1)[0]
    net.fit(ListDataSetIterator(DataSet(x, y), batch=5), epochs=2)
    c = net.clone()
    assert c.device == net.device and c.iteration == net.iteration
    a, b = net.get_param_table(), c.get_param_table()
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    torch.testing.assert_close(c.output(x), net.output(x), rtol=0, atol=0)
    # the same next step from the same state (updater slots, counters)
    net.fit(DataSet(x, y))
    c.fit(DataSet(x, y))
    assert c.score_ == net.score_ and c.iteration == net.iteration
    a, b = net.get_param_table(), c.get_param_table()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # independent: a change to the clone leaves the source alone
    with torch.no_grad():
        c.params["layer_0"]["W"].add_(1.0)
    assert np.array_equal(net.get_param_table()["layer_0/W"],
                          a["layer_0/W"])


def test_set_param_table_round_trips(rng):
    jnet, tnet = _mln_pair("ff")
    table = {k: v + 1.0 for k, v in tnet.get_param_table().items()}
    tnet.set_param_table(table)
    got = tnet.get_param_table()
    assert all(np.array_equal(got[k], table[k]) for k in table)
    jnet.set_param_table(table)
    x, _ = _ff_batches(rng, n=1)[0]
    np.testing.assert_allclose(tnet.output(x).numpy(), jnet.output(x),
                               atol=1e-6)
