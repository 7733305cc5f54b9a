"""The fit lifecycle slice against the JAX package: the listeners' events in
JAX's order (MultiLayerNetwork, tBPTT, ComputationGraph, ParallelWrapper
at one rank), on_fit_end on a failing step, the engine's keyword and
window refusals, the standard listeners, CheckpointManager resume and
checkpoints crossing the packages in both directions, and the iterators
(AsyncDataSetIterator's teardown: early break, reset mid-epoch, a producer
that raises).

Every wait on a producer thread is bounded, and each async test asserts
that no prefetch thread is left alive. Tolerances: params after Adam
steps 1e-5 absolute (tests/test_torch_training.py's Dense fits), scores
1e-5 relative; iterators and event sequences exactly.
"""
import json
import logging
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iterators as jits
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu.optimize import listeners as jlst
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel.mesh import build_mesh as jbuild_mesh
from deeplearning4j_tpu.resilience import checkpoint as jckpt
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    AsyncShieldDataSetIterator,
    AsyncShieldMultiDataSetIterator,
    BenchmarkDataSetIterator,
    DataSet,
    DataSetIterator,
    EarlyTerminationDataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultiDataSet,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)
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
from deeplearning4j_tpu_torch.optimize import listeners as tlst
from deeplearning4j_tpu_torch.resilience import (
    CheckpointListener,
    CheckpointManager,
    retry,
    retry_call,
)
from deeplearning4j_tpu_torch.resilience import checkpoint as tckpt
from deeplearning4j_tpu_torch.training import engine as tengine

WAIT = 10.0  # seconds: the bound on every wait for a producer thread


class Recorder:
    """Every lifecycle event, in order; usable by both packages."""

    def __init__(self):
        self.events = []

    def on_fit_start(self, model):
        self.events.append(("fit_start",))

    def on_epoch_start(self, model, epoch):
        self.events.append(("epoch_start", epoch, model.epoch))

    def on_epoch_end(self, model, epoch):
        self.events.append(("epoch_end", epoch, model.epoch))

    def on_fit_end(self, model):
        self.events.append(("fit_end",))

    def iteration_done(self, model, iteration, score):
        self.events.append(("iteration", iteration))

    def on_forward_pass(self, model, activations):
        pass

    def on_gradient_calculation(self, model):
        pass


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if "prefetch" in t.name and t.is_alive()]


def _wait_no_prefetch():
    deadline = time.monotonic() + WAIT
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _prefetch_threads() == []


def _dense_json(seed=4, dropout=None):
    return NeuralNetConfiguration(
        seed=seed, updater=updaters.Adam(learning_rate=0.05)).list([
            Dense(n_out=8, activation="relu", dropout=dropout),
            Output(n_out=3, loss="mcxent")]).set_input_type(
        it.feed_forward(4)).to_json()


def _rnn_json():
    return NeuralNetConfiguration(
        seed=3, updater=updaters.RmsProp(learning_rate=1e-2),
        backprop_type="tbptt", tbptt_fwd_length=4,
        tbptt_back_length=4).list([
            GravesLSTM(n_out=6),
            RnnOutput(n_out=5, loss="mcxent")]).set_input_type(
        it.recurrent(5)).to_json()


def _graph_json():
    g = NeuralNetConfiguration(
        seed=6, updater=updaters.Nesterovs(learning_rate=0.1,
                                           momentum=0.9)).graph()
    g.add_inputs("in")
    g.add_layer("d", Dense(n_out=7, activation="tanh"), "in")
    g.add_layer("out", Output(n_out=3, loss="mcxent"), "d")
    g.set_outputs("out")
    g.set_input_types(it.feed_forward(4))
    return g.to_json()


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


def _ff_data(seed=0, n=30):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _seq_data(seed=1):
    rng = np.random.default_rng(seed)
    x = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (6, 10))]
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (6, 10))]
    return x, y


def _assert_tables_close(tnet, jnet, tol=1e-5):
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    tt = tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], atol=tol, err_msg=k)


# ---------------------------------------------------------------- events
@pytest.mark.parametrize("kind", ["mln", "tbptt", "graph"])
def test_event_sequence_equals_jax(kind):
    """The port's events, event for event, equal JAX's for the same fit:
    one iteration_done per step (per tBPTT window), epoch events with
    model.epoch before its increment, on_fit_end last."""
    if kind == "mln":
        jnet, tnet = _pair(_dense_json())
        data, batch, epochs = _ff_data(), 10, 2
    elif kind == "tbptt":
        jnet, tnet = _pair(_rnn_json())
        data, batch, epochs = _seq_data(), 3, 2
    else:
        jnet, tnet = _pair(_graph_json(), graph=True)
        data, batch, epochs = _ff_data(), 10, 3
    jrec, trec = Recorder(), Recorder()
    jnet.set_listeners(jrec)
    tnet.set_listeners(trec)
    jnet.fit(jits.ListDataSetIterator(jds.DataSet(*data), batch=batch),
             epochs=epochs)
    tnet.fit(ListDataSetIterator(DataSet(*data), batch=batch),
             epochs=epochs)
    assert trec.events == jrec.events
    assert trec.events[0] == ("fit_start",) and \
        trec.events[-1] == ("fit_end",)
    assert tnet.epoch == jnet.epoch == epochs
    assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    _assert_tables_close(tnet, jnet)
    _wait_no_prefetch()


def test_parallel_wrapper_event_sequence_equals_jax(tmp_path):
    """ParallelWrapper at one rank (gloo, this process) against the JAX
    wrapper on one virtual device: the same events, the same params."""
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper,
        init_process_group,
    )

    jnet, tnet = _pair(_dense_json())
    data = _ff_data()
    jrec, trec = Recorder(), Recorder()
    jnet.set_listeners(jrec)
    tnet.set_listeners(trec)
    mesh = jbuild_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    JWrapper(jnet, mesh=mesh).fit(
        jits.ListDataSetIterator(jds.DataSet(*data), batch=10), epochs=2)
    init_process_group(f"file://{tmp_path}/rdv", 0, 1, device="cpu")
    try:
        pw = ParallelWrapper(tnet)
        pw.fit(ListDataSetIterator(DataSet(*data), batch=10), epochs=2)
        with pytest.raises(TypeError, match="unexpected keyword"):
            pw.fit(ListDataSetIterator(DataSet(*data), batch=10),
                   checkpointmanager=None)
    finally:
        torch.distributed.destroy_process_group()
    assert trec.events == jrec.events
    _assert_tables_close(tnet, jnet)
    _wait_no_prefetch()


@pytest.mark.parametrize("graph", [False, True])
def test_fit_end_fires_when_a_step_raises(graph, caplog):
    """A step that raises still ends with on_fit_end; a listener failing
    in on_fit_end is logged and does not mask the step's error; the
    prefetch producer fit started is gone."""
    _, net = _pair(_graph_json() if graph else _dense_json(), graph=graph)
    rec = Recorder()

    class Boom(tlst.TrainingListener):
        def iteration_done(self, model, iteration, score):
            if iteration == 2:
                raise KeyError("step 2")

        def on_fit_end(self, model):
            raise OSError("flush failed")

    net.set_listeners(rec, Boom())
    with caplog.at_level(logging.ERROR, logger="deeplearning4j_tpu_torch"):
        with pytest.raises(KeyError, match="step 2"):
            net.fit(ListDataSetIterator(DataSet(*_ff_data()), batch=5),
                    epochs=2)
    assert rec.events == [("fit_start",), ("epoch_start", 0, 0),
                          ("iteration", 1), ("iteration", 2), ("fit_end",)]
    assert "Boom.on_fit_end failed" in caplog.text
    _wait_no_prefetch()


def test_fire_lifecycle_swallow_logs_and_does_not_raise(caplog):
    class Bad:
        def on_fit_end(self, model):
            raise ValueError("bad")

    seen = []

    class Good:
        def on_fit_end(self, model):
            seen.append(model)

    with caplog.at_level(logging.ERROR, logger="deeplearning4j_tpu_torch"):
        tlst.fire_lifecycle([Bad(), Good(), object()], "on_fit_end", "m",
                            swallow=True)
    assert seen == ["m"] and "Bad.on_fit_end failed" in caplog.text
    with pytest.raises(ValueError, match="bad"):
        tlst.fire_lifecycle([Bad()], "on_fit_end", "m")


@pytest.mark.parametrize("graph", [False, True])
def test_unknown_fit_keyword_raises_jax_type_error(graph):
    jnet, tnet = _pair(_graph_json() if graph else _dense_json(),
                       graph=graph)
    x, y = _ff_data()
    with pytest.raises(TypeError) as jerr:
        jnet.fit(x, y, checkpoint_manger=None)
    with pytest.raises(TypeError) as terr:
        tnet.fit(x, y, checkpoint_manger=None)
    assert str(terr.value) == str(jerr.value)
    assert tnet.iteration == 0


def test_step_window_above_one_is_refused(monkeypatch):
    _, net = _pair(_dense_json())
    monkeypatch.setenv("DL4J_TPU_STEP_WINDOW", "4")
    with pytest.raises(NotImplementedError, match="A.7"):
        net.fit(*_ff_data())
    monkeypatch.setenv("DL4J_TPU_STEP_WINDOW", "1")
    net.fit(*_ff_data())
    assert net.iteration == 1 and tengine.window_size() == 1


# ---------------------------------------------------------------- listeners
def test_standard_listeners_match_jax(tmp_path):
    """Score, collect-scores, time and evaluative listeners record the
    same iterations in both packages; the parameter statistics name the
    same params with values within 1e-5; the performance listener counts
    the batch's rows."""
    jnet, tnet = _pair(_dense_json())
    x, y = _ff_data()
    jout, tout = [], []
    held_t = [DataSet(x[:12], y[:12])]
    held_j = [jds.DataSet(x[:12], y[:12])]

    def listeners(pkg, out, held, name):
        return [pkg.ScoreIterationListener(2, print_fn=out.append),
                pkg.CollectScoresListener(1),
                pkg.TimeIterationListener(6, frequency=3,
                                          print_fn=out.append),
                pkg.EvaluativeListener(held, frequency=3,
                                       print_fn=out.append),
                pkg.PerformanceListener(1, report_etl=False,
                                        print_fn=lambda s: None),
                pkg.SleepyTrainingListener(0.0),
                pkg.ParamAndGradientIterationListener(
                    2, output_file=str(tmp_path / name))]

    jl = listeners(jlst, jout, held_j, "jax.csv")
    tl = listeners(tlst, tout, held_t, "port.csv")
    jnet.set_listeners(*jl)
    tnet.set_listeners(*tl)
    jnet.fit(jits.ListDataSetIterator(jds.DataSet(x, y), batch=10),
             epochs=2)
    tnet.fit(ListDataSetIterator(DataSet(x, y), batch=10), epochs=2)
    assert [i for i, _ in tl[1].scores] == [i for i, _ in jl[1].scores] \
        == list(range(1, 7))
    np.testing.assert_allclose([s for _, s in tl[1].scores],
                               [s for _, s in jl[1].scores], rtol=1e-5)
    assert [s.split(" is ")[0] for s in tout if s.startswith("Score")] == \
        [s.split(" is ")[0] for s in jout if s.startswith("Score")]
    assert [s for s in tout if s.startswith("Evaluation")] == \
        [s for s in jout if s.startswith("Evaluation")]
    assert len([s for s in tout if s.startswith("Remaining")]) == 2
    assert tl[4].last_samples_per_sec > 0
    tcsv = (tmp_path / "port.csv").read_text().splitlines()
    jcsv = (tmp_path / "jax.csv").read_text().splitlines()
    assert len(tcsv) == len(jcsv) and tcsv[0] == jcsv[0]
    for a, b in zip(tcsv[1:], jcsv[1:]):
        ta, tb = a.split(","), b.split(",")
        assert ta[:3] == tb[:3]
        np.testing.assert_allclose([float(v) for v in ta[3:]],
                                   [float(v) for v in tb[3:]], atol=1e-5)


def test_profiler_listener_writes_a_trace_where_jax_writes(tmp_path):
    _, net = _pair(_dense_json())
    prof = tlst.ProfilerListener(str(tmp_path), start_iteration=1,
                                 num_iterations=2)
    net.set_listeners(prof)
    net.fit(ListDataSetIterator(DataSet(*_ff_data()), batch=5))
    assert len(prof.traces) == 1 and not prof._active
    path = prof.traces[0]
    assert path.startswith(str(tmp_path / "plugins" / "profile"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_simple_checkpoint_listener_keeps_the_last(tmp_path):
    _, net = _pair(_dense_json())
    lst = tlst.CheckpointListener(str(tmp_path), save_every_n_iterations=2,
                                  save_every_n_epochs=1, keep_last=2)
    net.set_listeners(lst)
    net.fit(ListDataSetIterator(DataSet(*_ff_data()), batch=5), epochs=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["checkpoint_epoch_1.zip", "checkpoint_iter_12.zip"]
    assert [os.path.basename(p) for p in lst.checkpoints()] == [
        "checkpoint_iter_12.zip", "checkpoint_epoch_1.zip"]


# ---------------------------------------------------------------- checkpoints
def test_checkpoint_manager_resume_matches_jax(tmp_path):
    """fit 2 epochs with a manager, then a fresh network fit to epochs=3
    with the same manager: it restores epoch 2 and trains one epoch, in
    both packages; the resumed port network equals an unbroken 3-epoch
    port fit bit for bit, and the JAX resumed network within 1e-5."""
    data = _ff_data()

    def run(pkg_net, it_cls, ds_cls, mgr, epochs):
        net = pkg_net()
        rec = Recorder()
        net.set_listeners(rec)
        net.fit(it_cls(ds_cls(*data), batch=10), epochs=epochs,
                checkpoint_manager=mgr)
        return net, rec

    conf = _dense_json()
    jm = jckpt.CheckpointManager(str(tmp_path / "jax"), keep_last=5)
    tm = CheckpointManager(str(tmp_path / "port"), keep_last=5)

    def jnet():
        return _pair(conf)[0]

    def tnet():
        return _pair(conf)[1]

    run(jnet, jits.ListDataSetIterator, jds.DataSet, jm, 2)
    run(tnet, ListDataSetIterator, DataSet, tm, 2)
    jres, jrec = run(jnet, jits.ListDataSetIterator, jds.DataSet, jm, 3)
    tres, trec = run(tnet, ListDataSetIterator, DataSet, tm, 3)
    assert trec.events == jrec.events
    assert [e for e in trec.events if e[0] == "iteration"] == [
        ("iteration", i) for i in (7, 8, 9)]
    assert tres.epoch == jres.epoch == 3 and tres.iteration == 9
    assert tm.list_steps() == jm.list_steps() == [3, 6, 9]
    assert all(tm.verify(s)[0] for s in tm.list_steps())
    _assert_tables_close(tres, jres)
    straight = _pair(conf)[1]
    straight.fit(ListDataSetIterator(DataSet(*data), batch=10), epochs=3)
    a, b = tres.get_param_table(), straight.get_param_table()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # a finished run resumes to nothing: epochs already reached
    again, rec = run(tnet, ListDataSetIterator, DataSet, tm, 3)
    assert [e[0] for e in rec.events] == ["fit_start", "fit_end"]


def test_checkpoints_cross_between_the_managers(tmp_path):
    """A JAX-written directory restored by the port's manager; the port's
    manifests pass JAX's verify and its checkpoints restore in JAX."""
    conf = _dense_json()
    jnet, tnet = _pair(conf)
    data = _ff_data()
    jnet.fit(jits.ListDataSetIterator(jds.DataSet(*data), batch=10))
    tnet.fit(ListDataSetIterator(DataSet(*data), batch=10))
    jm = jckpt.CheckpointManager(str(tmp_path / "j"))
    tm = CheckpointManager(str(tmp_path / "t"))
    jm.save(jnet)
    tm.save(tnet)
    # JAX -> port
    got, manifest = CheckpointManager(str(tmp_path / "j")).restore_latest(
        device="cpu")
    assert manifest["step"] == 3 and got.iteration == 3
    _assert_tables_close(got, jnet, tol=0)
    # port -> JAX
    jview = jckpt.CheckpointManager(str(tmp_path / "t"))
    assert jview.verify(3) == (True, "ok")
    back, jmanifest = jview.restore_latest()
    assert jmanifest["rng_key"] is None and "torch_generator" in jmanifest
    _assert_tables_close(tnet, back, tol=0)
    # the port resumes from the JAX directory, warning about its key
    fresh = _pair(conf)[1]
    with pytest.warns(UserWarning, match="rng_key"):
        CheckpointManager(str(tmp_path / "j")).restore_into(fresh)
    assert fresh.iteration == 3
    _assert_tables_close(fresh, jnet, tol=0)


def test_prune_and_keep_policy_match_jax(tmp_path):
    _, tnet = _pair(_dense_json())
    jnet = _pair(_dense_json())[0]
    tm = CheckpointManager(str(tmp_path / "t"), keep_last=2, keep_every=4)
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), keep_last=2,
                                 keep_every=4)
    for step in range(1, 10):
        tm.save(tnet, step=step)
        jm.save(jnet, step=step)
    assert tm.list_steps() == jm.list_steps() == [4, 8, 9]
    assert tm.prune(keep_last=1, keep_every=0) == \
        jm.prune(keep_last=1, keep_every=0) == [4, 8]
    assert [m["step"] for m in tm.manifests()] == [9]


def test_restore_latest_walks_past_a_torn_checkpoint(tmp_path, caplog):
    _, net = _pair(_dense_json())
    m = CheckpointManager(str(tmp_path))
    m.save(net, step=1)
    net.fit(*_ff_data())
    m.save(net, step=2)
    with open(m._zip(2), "r+b") as f:
        f.seek(100)
        f.write(b"torn")
    assert m.verify(2)[0] is False and m.verify(1) == (True, "ok")
    got, manifest = m.restore_latest(device="cpu")
    assert manifest["step"] == 1 and "unrestorable" in caplog.text
    with pytest.raises(IOError, match="sha256"):
        m.restore(2, device="cpu")


def test_resume_carries_the_dropout_generator(tmp_path):
    """With dropout the masks come from the network's generator: a run
    resumed from its checkpoint draws the masks the unbroken run draws."""
    conf = _dense_json(dropout=0.6)
    data = _ff_data()
    m = CheckpointManager(str(tmp_path))
    first = _pair(conf)[1]
    first.fit(ListDataSetIterator(DataSet(*data), batch=10), epochs=1,
              checkpoint_manager=m)
    first.draws.generator.manual_seed(123)  # a stale generator is replaced
    resumed = _pair(conf)[1]
    resumed.fit(ListDataSetIterator(DataSet(*data), batch=10), epochs=2,
                checkpoint_manager=m)
    straight = _pair(conf)[1]
    straight.fit(ListDataSetIterator(DataSet(*data), batch=10), epochs=2)
    a, b = resumed.get_param_table(), straight.get_param_table()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_resilience_checkpoint_listener_matches_jax_manifests(tmp_path):
    jnet, tnet = _pair(_dense_json())
    data = _ff_data()
    jl = jckpt.CheckpointListener(str(tmp_path / "j"),
                                  save_every_n_iterations=4,
                                  save_every_n_epochs=1, keep_last=10)
    tl = CheckpointListener(str(tmp_path / "t"), save_every_n_iterations=4,
                            save_every_n_epochs=1, keep_last=10)
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    jnet.fit(jits.ListDataSetIterator(jds.DataSet(*data), batch=5), epochs=2)
    tnet.fit(ListDataSetIterator(DataSet(*data), batch=5), epochs=2)
    keys = ("step", "iteration", "epoch", "trigger")
    assert [{k: m.get(k) for k in keys} for m in tl.manager.manifests()] \
        == [{k: m.get(k) for k in keys} for m in jl.manager.manifests()]
    with pytest.raises(ValueError, match="trigger"):
        CheckpointListener(str(tmp_path / "x"))


def test_atomic_writers_leave_no_temporary(tmp_path):
    _, net = _pair(_dense_json())
    sha = tckpt.atomic_write_model(net, str(tmp_path / "m.zip"))
    tckpt.atomic_write_json(str(tmp_path / "m.json"), {"sha": sha})
    assert sorted(os.listdir(tmp_path)) == ["m.json", "m.zip"]
    assert json.loads((tmp_path / "m.json").read_text())["sha"] == sha == \
        tckpt._sha256_file(str(tmp_path / "m.zip"))


def test_retry_backs_off_and_gives_up():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky")
        return "done"

    assert retry_call(flaky, attempts=4, backoff=0.5, jitter=0.0,
                      sleep=sleeps.append) == "done"
    assert sleeps == [0.5, 1.0]

    @retry(attempts=2, backoff=0.0, retry_on=(ValueError,))
    def always():
        raise ValueError("no")

    with pytest.raises(ValueError):
        always()


# ---------------------------------------------------------------- iterators
def _batches(n=5, b=4, seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (b, 3)).astype(np.float32),
             rng.normal(0, 1, (b, 2)).astype(np.float32)) for _ in range(n)]


def _arrays(it_):
    return [(np.asarray(d.features), np.asarray(d.labels)) for d in it_]


def _same(a, b):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("kind", ["existing", "multiple_epochs",
                                  "early_termination", "sampling",
                                  "benchmark", "async", "async_shield"])
def test_iterator_yields_jax_sequence(kind):
    bs = _batches()
    big_x = np.concatenate([x for x, _ in bs])
    big_y = np.concatenate([y for _, y in bs])

    def make(pkg_its, ds_cls):
        if kind == "existing":
            return pkg_its.ExistingDataSetIterator([ds_cls(*b) for b in bs])
        if kind == "multiple_epochs":
            return pkg_its.MultipleEpochsIterator(
                3, pkg_its.ListDataSetIterator(ds_cls(big_x, big_y), 7))
        if kind == "early_termination":
            return pkg_its.EarlyTerminationDataSetIterator(
                pkg_its.ListDataSetIterator(ds_cls(big_x, big_y), 3), 4)
        if kind == "sampling":
            return pkg_its.SamplingDataSetIterator(ds_cls(big_x, big_y), 6,
                                                   5, seed=9)
        if kind == "benchmark":
            return pkg_its.BenchmarkDataSetIterator((4, 3, 2), 5,
                                                    total_batches=3, seed=2)
        inner = pkg_its.ListDataSetIterator(ds_cls(big_x, big_y), 3,
                                            shuffle_each_epoch=True, seed=5)
        if kind == "async":
            return pkg_its.AsyncDataSetIterator(inner, 2)
        return pkg_its.AsyncShieldDataSetIterator(inner)

    import deeplearning4j_tpu_torch.datasets.iterators as tits

    t, j = make(tits, DataSet), make(jits, jds.DataSet)
    for _ in range(2):  # two epochs: resets and reshuffles agree
        _same(_arrays(t), _arrays(j))
    assert t.async_supported() == j.async_supported() == (
        kind != "async_shield")
    if kind == "async":
        t.shutdown()
        j.shutdown()
    _wait_no_prefetch()


def test_async_multi_dataset_iterators():
    mds = [MultiDataSet([x, x + 1], [y]) for x, y in _batches()]

    class Source(DataSetIterator):
        def __init__(self):
            self.i = 0

        def reset(self):
            self.i = 0

        def __next__(self):
            if self.i >= len(mds):
                raise StopIteration
            self.i += 1
            return mds[self.i - 1]

    a = AsyncMultiDataSetIterator(Source(), 2)
    got = list(a)
    assert [g is m for g, m in zip(got, mds)] == [True] * len(mds)
    assert not AsyncShieldMultiDataSetIterator(Source()).async_supported()
    a.shutdown()
    _wait_no_prefetch()


def test_async_early_break_and_reset_mid_epoch_leave_no_thread():
    src = ListDataSetIterator(DataSet(*map(np.concatenate,
                                           zip(*_batches(n=40)))), 2)
    a = AsyncDataSetIterator(src, 2)
    first = [next(iter(a)) for _ in range(1)]
    assert first[0].features.shape == (2, 3)
    for i, _ in enumerate(a):  # break while the producer waits on a full queue
        if i == 3:
            break
    a.reset()  # mid-epoch: the old producer stopped, a new one starts
    assert len(list(a)) == 80
    for i, _ in enumerate(a):
        if i == 1:
            break
    a.shutdown()
    a.shutdown()  # idempotent
    _wait_no_prefetch()
    # early termination over an async producer stops the consumer at 3
    e = EarlyTerminationDataSetIterator(AsyncDataSetIterator(src, 1), 3)
    assert len(list(e)) == 3
    e.underlying.shutdown()
    _wait_no_prefetch()


def test_async_producer_error_is_raised_on_the_consumer():
    class Failing(DataSetIterator):
        def __init__(self):
            self.n = 0

        def reset(self):
            self.n = 0

        def __next__(self):
            self.n += 1
            if self.n == 3:
                raise RuntimeError("source broke")
            return DataSet(*_batches(n=1)[0])

    a = AsyncDataSetIterator(Failing(), 1)
    got = []
    with pytest.raises(RuntimeError, match="source broke"):
        for d in a:
            got.append(d)
    assert len(got) == 2
    with pytest.raises(RuntimeError, match="source broke"):
        next(a)  # the ended stream keeps raising, never blocks
    a.shutdown()
    _wait_no_prefetch()
    # through fit: the error reaches the caller, no producer survives
    _, net = _pair(_dense_json())
    rec = Recorder()
    net.set_listeners(rec)

    class FailingFF(Failing):
        def __next__(self):
            self.n += 1
            if self.n == 3:
                raise RuntimeError("source broke")
            return DataSet(*_ff_data(n=4))

    with pytest.raises(RuntimeError, match="source broke"):
        net.fit(FailingFF())
    assert net.iteration == 2 and rec.events[-1] == ("fit_end",)
    _wait_no_prefetch()


@pytest.mark.parametrize("graph", [False, True])
def test_fit_wraps_an_iterator_in_async_prefetch(graph):
    """fit iterates a DataSetIterator through a prefetch thread (none for
    a shielded one), and the thread is gone when fit returns."""
    _, net = _pair(_graph_json() if graph else _dense_json(), graph=graph)
    names = []

    class Source(ListDataSetIterator):
        def __next__(self):
            names.append(threading.current_thread().name)
            return ListDataSetIterator.__next__(self)

    src = Source(DataSet(*_ff_data()), batch=5)
    net.fit(src, epochs=2)
    _wait_no_prefetch()
    assert len(names) == 14 and all("prefetch" in n for n in names)
    names.clear()
    net.fit(AsyncShieldDataSetIterator(src))
    assert names == [threading.current_thread().name] * 7
    assert net.iteration == 18
    _wait_no_prefetch()


def test_async_iterators_under_a_short_switch_interval():
    """Many producers at once (more threads than cores), queues of depth
    1, the interpreter switching threads every microsecond: each consumer
    sees its source's batches in order, none lost or doubled, and every
    producer is gone afterwards. Bounded: each next() has a producer, and
    every teardown waits at most WAIT."""
    import sys

    n_iters = 2 * (os.cpu_count() or 4)
    srcs = [ExistingDataSetIterator([DataSet(np.full((1, 1), k, np.float32),
                                             np.full((1, 1), i, np.float32))
                                     for k in range(30)])
            for i in range(n_iters)]
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        its = [AsyncDataSetIterator(s, 1) for s in srcs]
        streams = [iter(a) for a in its]
        got = [[] for _ in its]
        for _ in range(30):
            for i, st in enumerate(streams):
                d = next(st)
                got[i].append((float(d.features[0, 0]),
                               float(d.labels[0, 0])))
        for i, st in enumerate(streams):
            with pytest.raises(StopIteration):
                next(st)
        for a in its:
            a.shutdown()
    finally:
        sys.setswitchinterval(saved)
    assert got == [[(float(k), float(i)) for k in range(30)]
                   for i in range(n_iters)]
    _wait_no_prefetch()
