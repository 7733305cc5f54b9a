"""Step windows and device prefetch of the port (deeplearning4j_tpu_torch/
training/engine.py `WindowedFitLoop`, `device_prefetch_place`;
AsyncDataSetIterator's `place`) against the per-step loop and the JAX
package.

The contract: a window of K steps (`DL4J_TPU_STEP_WINDOW=K`) equals K
single steps bit for bit in the port (params, updater slots, the dropout
generator, scores, counters), for a MultiLayerNetwork with dropout and a
ComputationGraph, with a ragged tail that flushes the window early; K = 4
against the JAX package's K = 4 within 1e-5 (the JAX keys replayed for
dropout); listeners see every step; a change of signature flushes; an
exception in the middle of an epoch drops the staged batches; resume and
the CheckpointListener deferral hold under windows; `place` runs on the
producer thread, its error comes out on the consumer, a reset in the
middle of the stream drains cleanly; and ParallelWrapper at K = 4 over two
gloo ranks (spawned as tests/torch_dp_worker.py processes) equals its
per-step run bit for bit and one process within 1e-5.
"""
import itertools
import json
import os
import subprocess
import sys
import threading

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
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresListener as JCollectScores,
)
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator,
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
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
from deeplearning4j_tpu_torch.nn.layers import Dense, Output
from deeplearning4j_tpu_torch.optimize import listeners as tlst
from deeplearning4j_tpu_torch.resilience import (
    CheckpointListener,
    CheckpointManager,
)
from deeplearning4j_tpu_torch.training import engine
from tests.torch_keys import JaxKeys

WINDOW = "DL4J_TPU_STEP_WINDOW"
PREFETCH = "DL4J_TPU_DEVICE_PREFETCH"
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dp_worker.py")
_RUN = itertools.count()


def _mln_json(seed=7, dropout=None):
    return NeuralNetConfiguration(
        seed=seed, updater=updaters.Adam(learning_rate=5e-3)).list([
            Dense(n_out=16, activation="relu", dropout=dropout),
            Output(n_out=3, loss="mcxent")]).set_input_type(
        it.feed_forward(4)).to_json()


def _cg_json(seed=7):
    g = NeuralNetConfiguration(
        seed=seed, updater=updaters.Adam(learning_rate=5e-3)).graph()
    g.add_inputs("in")
    g.add_layer("h", Dense(n_out=16, activation="relu"), "in")
    g.add_layer("out", Output(n_out=3, loss="mcxent"), "h")
    g.set_outputs("out")
    g.set_input_types(it.feed_forward(4))
    return g.to_json()


def _net(conf_json, graph=False):
    if graph:
        return ComputationGraph(ComputationGraphConfiguration.from_json(
            conf_json)).init(device="cpu")
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf_json)).init(device="cpu")


def _pair(conf_json, graph=False):
    jnet = (JCG(JGConf.from_json(conf_json)) if graph
            else JMLN(JConf.from_json(conf_json))).init()
    tnet = _net(conf_json, graph)
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _data(seed=0, n=30):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return DataSet(x, y)


def _slots(net):
    slots = interop.opt_state_to_jax(net)
    entries = slots.items() if isinstance(slots, dict) else enumerate(slots)
    out = {}
    for key, entry in entries:
        for path, leaf in jax.tree_util.tree_flatten_with_path(entry)[0]:
            out[f"{key}{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
    return out


def _assert_bitwise(a, b):
    assert a.iteration == b.iteration and a.epoch == b.epoch
    assert a.score_ == b.score_
    ta, tb = a.get_param_table(), b.get_param_table()
    assert list(ta) == list(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    sa, sb = _slots(a), _slots(b)
    assert list(sa) == list(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert torch.equal(a.draws.generator.get_state(),
                       b.draws.generator.get_state())


class Log(tlst.TrainingListener):
    """Iterations and scores, and each window's (start, end) iteration."""

    def __init__(self):
        self.steps, self.windows = [], []

    def iteration_done(self, model, iteration, score):
        self.steps.append((iteration, score))

    def on_window_start(self, model):
        self.windows.append([model.iteration, None])

    def on_window_end(self, model):
        self.windows[-1][1] = model.iteration


# ------------------------------------------------------------ windows
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("window", ["4", "8"])
def test_window_equals_single_steps_bitwise(graph, window, monkeypatch):
    """2 epochs of 7-row batches over 30 rows (4 full and a 2-row tail
    that flushes the window): K = 4 and 8 against K = 1, bit for bit,
    with dropout 0.5 drawing from the port's own generator (MLN)."""
    conf = _cg_json() if graph else _mln_json(dropout=0.5)
    monkeypatch.delenv(WINDOW, raising=False)
    control, clog = _net(conf, graph), Log()
    control.set_listeners(clog)
    control.fit(ListDataSetIterator(_data(), batch=7), epochs=2)
    monkeypatch.setenv(WINDOW, window)
    windowed, wlog = _net(conf, graph), Log()
    windowed.set_listeners(wlog)
    windowed.fit(ListDataSetIterator(_data(), batch=7), epochs=2)
    _assert_bitwise(control, windowed)
    assert wlog.steps == clog.steps
    assert clog.windows == []
    # per epoch: the four 7-row batches, then the tail on its own
    assert wlog.windows == [[0, 4], [4, 5], [5, 9], [9, 10]]


@pytest.mark.parametrize("graph", [False, True])
def test_window_4_matches_jax_window_4(graph, monkeypatch):
    """K = 4 in both packages over 2 epochs of 6-row batches: the MLN with
    dropout 0.7 (the JAX keys replayed into the port's draws) and the
    graph; params within 1e-5, every step's score within 1e-5
    relative."""
    conf = _cg_json() if graph else _mln_json(dropout=0.7)
    monkeypatch.setenv(WINDOW, "4")
    jnet, tnet = _pair(conf, graph)
    if not graph:
        tnet.draws = JaxKeys.for_net(7)
    jlog, tlog = JCollectScores(), Log()
    jnet.set_listeners(jlog)
    tnet.set_listeners(tlog)
    ds = _data(3)
    jnet.fit(jits.ListDataSetIterator(jds.DataSet(ds.features, ds.labels),
                                      batch=6), epochs=2)
    tnet.fit(ListDataSetIterator(ds, batch=6), epochs=2)
    assert len(jnet._window_scan_cache) >= 1  # JAX windowed too
    assert [i for i, _ in tlog.steps] == [i for i, _ in jlog.scores]
    for (_, got), (_, want) in zip(tlog.steps, jlog.scores):
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    for k, v in tnet.get_param_table().items():
        np.testing.assert_allclose(v, jt[k], atol=1e-5, err_msg=k)
    assert tnet.iteration == jnet.iteration == 10


def test_listeners_see_every_step_in_order(monkeypatch):
    monkeypatch.setenv(WINDOW, "4")
    net, log = _net(_mln_json()), Log()
    col = tlst.CollectScoresListener()
    net.set_listeners(log, col)
    net.fit(ListDataSetIterator(_data(), batch=6), epochs=2)
    assert [i for i, _ in log.steps] == list(range(1, 11))
    assert [i for i, _ in col.scores] == list(range(1, 11))
    assert all(np.isfinite(s) for _, s in log.steps)
    assert log.windows == [[0, 4], [4, 5], [5, 9], [9, 10]]
    assert net.last_batch_size == 6


def test_signature_change_flushes_the_window(monkeypatch):
    """Batches of 5, 5, 3 (new shape), 3, a masked 3 (new structure), 5:
    every change of shapes, dtypes or of which masks are None starts a
    new window; the steps equal the per-step loop's."""
    rng = np.random.default_rng(4)
    rows = [5, 5, 3, 3, 3, 5]
    batches = []
    for i, r in enumerate(rows):
        x = rng.normal(size=(r, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, r)]
        lm = np.ones((r, 1), np.float32) if i == 4 else None
        batches.append(DataSet(x, y, None, lm))
    a = engine._signature((torch.zeros(2, 3), None))
    assert a == engine._signature((torch.ones(2, 3), None))
    assert a != engine._signature((torch.zeros(2, 3), torch.zeros(2)))
    assert a != engine._signature((torch.zeros(3, 3), None))
    assert a != engine._signature((torch.zeros(2, 3, dtype=torch.int64),
                                   None))

    class Batches(DataSetIterator):
        def __init__(self):
            self.i = 0

        def reset(self):
            self.i = 0

        def __next__(self):
            if self.i == len(batches):
                raise StopIteration
            self.i += 1
            return batches[self.i - 1]

    monkeypatch.delenv(WINDOW, raising=False)
    control = _net(_mln_json())
    control.fit(Batches())
    monkeypatch.setenv(WINDOW, "8")
    net, log = _net(_mln_json()), Log()
    net.set_listeners(log)
    net.fit(Batches())
    assert log.windows == [[0, 2], [2, 4], [4, 5], [5, 6]]
    _assert_bitwise(control, net)


def test_exception_mid_epoch_drops_staged_batches(monkeypatch):
    """The iterator raises at its third batch: the two staged batches were
    never applied (iteration 0, params as initialized), and on_fit_end
    still fires."""
    class Failing(DataSetIterator):
        def __init__(self):
            self.i = 0

        def reset(self):
            self.i = 0

        def async_supported(self):
            return False

        def __next__(self):
            self.i += 1
            if self.i == 3:
                raise RuntimeError("source lost")
            return _data(self.i, 6)

    monkeypatch.setenv(WINDOW, "4")
    net = _net(_mln_json())
    before = net.get_param_table()
    ended = []

    class End(tlst.TrainingListener):
        def on_fit_end(self, model):
            ended.append(model.iteration)

    net.set_listeners(End())
    with pytest.raises(RuntimeError, match="source lost"):
        net.fit(Failing())
    assert net.iteration == 0 and ended == [0]
    for k, v in net.get_param_table().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


@pytest.mark.parametrize("graph", [False, True])
def test_resume_equals_unbroken_run_under_windows(graph, tmp_path,
                                                  monkeypatch):
    """fit 2 epochs with a CheckpointManager, then fit(epochs=4) resumed
    from it, equals fit(epochs=4) in one go, bit for bit, at K = 4."""
    monkeypatch.setenv(WINDOW, "4")
    conf = _cg_json() if graph else _mln_json(dropout=0.6)
    it_ = ListDataSetIterator(_data(), batch=6)
    control = _net(conf, graph)
    control.fit(it_, epochs=4,
                checkpoint_manager=CheckpointManager(str(tmp_path / "c")))
    cm = CheckpointManager(str(tmp_path / "r"))
    first = _net(conf, graph)
    first.fit(it_, epochs=2, checkpoint_manager=cm)
    resumed = _net(conf, graph)
    resumed.fit(it_, epochs=4, checkpoint_manager=cm)
    assert resumed.epoch == 4
    _assert_bitwise(control, resumed)


@pytest.mark.parametrize("which", ["resilience", "optimize"])
def test_checkpoint_listener_defers_mid_window_saves(which, tmp_path,
                                                     monkeypatch):
    """Saves due at iterations 2 and 4 fall inside the first window of 4
    and are made once, at its end (iteration 4); the saved checkpoint
    restores the state a per-step run saves at iteration 4."""
    monkeypatch.setenv(WINDOW, "4")
    net = _net(_mln_json())
    if which == "resilience":
        cm = CheckpointManager(str(tmp_path / "w"))
        net.set_listeners(CheckpointListener(cm, save_every_n_iterations=2))
    else:
        lst = tlst.CheckpointListener(str(tmp_path / "w"),
                                      save_every_n_iterations=2)
        net.set_listeners(lst)
    net.fit(ListDataSetIterator(_data(), batch=6))
    if which == "optimize":
        # windows 1-4 and the tail 5: the deferred save at 4, none at 5
        assert [os.path.basename(p) for p in lst.checkpoints()] == [
            "checkpoint_iter_4.zip"]
        return
    assert [m["step"] for m in cm.manifests()] == [4]
    monkeypatch.delenv(WINDOW, raising=False)
    control = _net(_mln_json())
    cm2 = CheckpointManager(str(tmp_path / "c"))
    control.set_listeners(CheckpointListener(cm2, save_every_n_iterations=4))
    control.fit(ListDataSetIterator(_data(), batch=6))
    a, b = _net(_mln_json()), _net(_mln_json())
    cm2.restore_into(a)
    cm.restore_into(b)
    assert a.iteration == b.iteration == 4
    for k, v in a.get_param_table().items():
        np.testing.assert_array_equal(v, b.get_param_table()[k], err_msg=k)


# ------------------------------------------------------------ prefetch
def _base(n=6):
    """n 4-row batches; batch i's features are the constant i."""
    x = np.tile(np.repeat(np.arange(n, dtype=np.float32), 4)[:, None],
                (1, 4))
    return ListDataSetIterator(DataSet(x, np.ones((4 * n, 3), np.float32)),
                               batch=4)


def test_device_prefetch_gate(monkeypatch):
    monkeypatch.delenv(PREFETCH, raising=False)
    assert engine.device_prefetch_place("cpu") is None
    monkeypatch.setenv(PREFETCH, "garbage")
    assert engine.device_prefetch_place("cpu") is None
    monkeypatch.setenv(PREFETCH, "1")
    place = engine.device_prefetch_place("cpu")
    out = place(DataSet(np.ones((2, 4), np.float32),
                        np.ones((2, 3), np.float32)))
    assert isinstance(out.features, torch.Tensor)
    assert out.features_mask is None
    monkeypatch.delenv(WINDOW, raising=False)
    assert engine.window_size() == 1
    monkeypatch.setenv(WINDOW, "0")
    assert engine.window_size() == 1


def test_place_runs_on_the_producer_thread():
    seen, main = [], threading.get_ident()

    def place(ds):
        seen.append(threading.get_ident())
        return engine.place_batch(ds, torch.as_tensor)

    ait = AsyncDataSetIterator(_base(), place=place)
    got = list(ait)
    ait.shutdown()
    assert len(got) == len(seen) == 6
    assert all(t != main for t in seen)
    assert all(isinstance(d.features, torch.Tensor) for d in got)
    assert [float(d.features[0, 0]) for d in got] == [0, 1, 2, 3, 4, 5]


def test_place_error_comes_out_on_the_consumer():
    def bad(ds):
        raise RuntimeError("copy failed")

    ait = AsyncDataSetIterator(_base(), place=bad)
    with pytest.raises(RuntimeError, match="copy failed"):
        list(ait)
    ait.shutdown()
    assert ait._thread is None


def test_reset_mid_stream_with_place_drains_cleanly():
    ait = AsyncDataSetIterator(
        _base(), queue_size=2,
        place=lambda d: engine.place_batch(d, torch.as_tensor))
    it1 = iter(ait)
    next(it1), next(it1)
    ait.reset()
    assert [float(d.features[0, 0]) for d in ait] == [0, 1, 2, 3, 4, 5]
    ait.shutdown()
    ait.shutdown()  # idempotent
    assert ait._thread is None


def test_fit_under_device_prefetch_and_window_matches(monkeypatch):
    """DL4J_TPU_DEVICE_PREFETCH moves where the batch becomes a tensor on
    the device (the producer), never the numbers; with K = 4 as well."""
    monkeypatch.delenv(PREFETCH, raising=False)
    monkeypatch.delenv(WINDOW, raising=False)
    control = _net(_mln_json(dropout=0.5))
    control.fit(ListDataSetIterator(_data(), batch=6), epochs=2)
    monkeypatch.setenv(PREFETCH, "1")
    monkeypatch.setenv(WINDOW, "4")
    net = _net(_mln_json(dropout=0.5))
    net.fit(ListDataSetIterator(_data(), batch=6), epochs=2)
    _assert_bitwise(control, net)


# ------------------------------------------------------------ wrapper
def _spawn(tmp_path, world, **spec):
    run = next(_RUN)
    init = f"file://{tmp_path}/rdv{run}"
    procs, outs = [], []
    for r in range(world):
        out = str(tmp_path / f"run{run}_rank{r}.npz")
        path = tmp_path / f"run{run}_spec{r}.json"
        path.write_text(json.dumps(dict(spec, rank=r, world=world,
                                        init=init, out=out)))
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [dict(np.load(o)) for o in outs]


def test_wrapper_window_over_two_gloo_ranks(tmp_path, monkeypatch):
    """ParallelWrapper over two gloo ranks at K = 4 (2 epochs of 5 batches
    of 6 rows): both ranks bit for bit equal
    to each other and to the ranks' per-step run, windows engaged, and
    within 1e-5 of one process's fit on the global batches."""
    ds = _data(8, 30)
    data = str(tmp_path / "data.npz")
    np.savez(data, x=ds.features, y=ds.labels)
    conf = _mln_json(seed=11)
    spec = dict(kind="mln", conf=conf, data=data, batch=6, epochs=2)
    monkeypatch.setenv(WINDOW, "4")
    windowed = _spawn(tmp_path, 2, **spec)
    monkeypatch.delenv(WINDOW)
    stepped = _spawn(tmp_path, 2, **spec)
    assert [int(r["windows"]) for r in windowed] == [4, 4]
    assert [int(r["windows"]) for r in stepped] == [0, 0]
    for r in windowed + stepped[1:]:
        for k, v in stepped[0].items():
            if k.startswith(("param/", "slot/")) or k == "scores":
                np.testing.assert_array_equal(r[k], v, err_msg=k)
    single = _net(conf)
    log = Log()
    single.set_listeners(log)
    single.fit(ListDataSetIterator(ds, batch=6), epochs=2)
    got = windowed[0]
    assert int(got["iteration"]) == single.iteration == 10
    assert int(got["last_batch_size"]) == 6
    np.testing.assert_allclose(got["scores"], [s for _, s in log.steps],
                               rtol=1e-5)
    for k, v in single.get_param_table().items():
        np.testing.assert_allclose(got[f"param/{k}"], v, atol=1e-5,
                                   err_msg=k)
