"""The divergence sentry of the port (deeplearning4j_tpu_torch/resilience/
sentry.py) against the JAX package's, per step and under step windows.

The JAX package's windowed-resilience cases (tests/test_training_engine.py
TestWindowedResilience) run here in both packages on the same data and
weights: a NaN batch in the middle of a window trips the sentry once,
rolls back once and the run ends finite; a windowed fit does not switch
off the per-step rules of a later fit; the replay stops at a rollback (no
ghost iterations: the final iteration and every listener's iteration list
equal JAX's); warn detects and carries on. The JAX side injects its NaN
batch with ChaosDataSetIterator; the port, whose chaos fault points are
not ported yet, with a test-local iterator that does the same. Then the
per-step policies (skip_batch, rollback through a CheckpointManager, the
budget, parameter checks, on_empty), the snapshot and restore round trip
(the dropout generator included, the live param tensors kept) and the
update-norm spike test's norms against JAX. Params within 1e-5 of JAX's
after Adam steps; norms within 1e-5 relative; iterations exactly.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iterators as jits
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresListener as JCollectScores,
)
from deeplearning4j_tpu.resilience import ChaosDataSetIterator
from deeplearning4j_tpu.resilience import CheckpointListener as JCkptListener
from deeplearning4j_tpu.resilience import CheckpointManager as JManager
from deeplearning4j_tpu.resilience import DivergenceSentry as JSentry
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import Dense, Output
from deeplearning4j_tpu_torch.optimize.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.resilience import (
    CheckpointListener,
    CheckpointManager,
    DivergenceSentry,
    restore_training_state,
    snapshot_training_state,
    tree_all_finite,
)

WINDOW = "DL4J_TPU_STEP_WINDOW"


def _conf_json(seed=7, dropout=None):
    return NeuralNetConfiguration(
        seed=seed, updater=updaters.Adam(learning_rate=5e-3)).list([
            Dense(n_out=16, activation="relu", dropout=dropout),
            Output(n_out=3, loss="mcxent")]).set_input_type(
        it.feed_forward(4)).to_json()


def _pair(seed=7):
    conf = _conf_json(seed)
    jnet = JMLN(JConf.from_json(conf)).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf)).init(
        device="cpu")
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _iris_like(seed=0):
    """150 x 4 features of 3 separable classes."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, (3, 4))
    ids = rng.integers(0, 3, 150)
    x = (centers[ids] + rng.normal(0, 0.5, (150, 4))).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[ids]


class NanAt(DataSetIterator):
    """The port's stand-in for ChaosDataSetIterator(nan_at=...): counting
    batches from 1 across epochs, those at `nan_at` come with NaN
    features; synchronous, as the chaos iterator is."""

    def __init__(self, underlying, nan_at=()):
        self.underlying = underlying
        self.nan_at = frozenset(nan_at)
        self.count = 0

    def reset(self):
        self.underlying.reset()

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        ds = next(self.underlying)
        self.count += 1
        if self.count in self.nan_at:
            ds = DataSet(np.full_like(np.asarray(ds.features), np.nan),
                         ds.labels, ds.features_mask, ds.labels_mask)
        return ds

    def batch_size(self):
        return self.underlying.batch_size()

    def async_supported(self):
        return False


def _iters(batch=30, nan_at=()):
    x, y = _iris_like()
    j = ChaosDataSetIterator(
        jits.ListDataSetIterator(jds.DataSet(x, y), batch=batch),
        nan_at=nan_at)
    t = NanAt(ListDataSetIterator(DataSet(x, y), batch=batch), nan_at)
    return j, t


def _assert_close(jnet, tnet, tol=1e-5):
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    for k, v in tnet.get_param_table().items():
        assert np.isfinite(v).all(), k
        np.testing.assert_allclose(v, jt[k], atol=tol, err_msg=k)


# ------------------------------------------------------------ under windows
def test_sentry_trips_on_nan_mid_window(monkeypatch):
    """A NaN batch at position 2 of a window of 4: one divergence, one
    rollback to the clean start of the window, the run finite; both
    packages end at the same iteration with the same params."""
    monkeypatch.setenv(WINDOW, "4")
    jnet, tnet = _pair()
    js = JSentry(policy="skip_batch", max_rollbacks=2, snapshot_every=1)
    ts = DivergenceSentry(policy="skip_batch", max_rollbacks=2,
                          snapshot_every=1)
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jit_, tit = _iters(nan_at=(2,))
    jnet.fit(jit_, epochs=1)
    tnet.fit(tit, epochs=1)
    assert (ts.divergences, ts.rollbacks) == (js.divergences,
                                              js.rollbacks) == (1, 1)
    assert np.isfinite(tnet.score_)
    assert tnet.iteration == jnet.iteration
    _assert_close(jnet, tnet)


def test_windowed_state_resets_between_fits(monkeypatch):
    """A windowed fit, then a per-step fit on the same sentry with a NaN
    batch at 3: the later fit restores its per-iteration snapshot."""
    jnet, tnet = _pair()
    js = JSentry(policy="skip_batch", max_rollbacks=2, snapshot_every=1)
    ts = DivergenceSentry(policy="skip_batch", max_rollbacks=2,
                          snapshot_every=1)
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    monkeypatch.setenv(WINDOW, "4")
    jit_, tit = _iters()
    jnet.fit(jit_, epochs=1)
    tnet.fit(tit, epochs=1)
    monkeypatch.delenv(WINDOW)
    jit_, tit = _iters(nan_at=(3,))
    jnet.fit(jit_, epochs=1)
    tnet.fit(tit, epochs=1)
    assert not ts._windowed and ts.rollbacks == js.rollbacks == 1
    assert tnet.iteration == jnet.iteration
    _assert_close(jnet, tnet)


def test_rollback_stops_replay_no_ghost_iterations(monkeypatch):
    """After the rollback in the middle of the replay the engine stops
    replaying: window 1 replays iterations 1 and 2 (NaN: trip, restore to
    0), the tail window's batch is iteration 1; a score collector sees
    [1, 2, 1] in both packages."""
    monkeypatch.setenv(WINDOW, "4")
    jnet, tnet = _pair()
    jcol, tcol = JCollectScores(), CollectScoresListener()
    js = JSentry(policy="skip_batch", max_rollbacks=2, snapshot_every=1)
    ts = DivergenceSentry(policy="skip_batch", max_rollbacks=2,
                          snapshot_every=1)
    jnet.set_listeners(jcol, js)
    tnet.set_listeners(tcol, ts)
    jit_, tit = _iters(nan_at=(2,))
    jnet.fit(jit_, epochs=1)
    tnet.fit(tit, epochs=1)
    assert [i for i, _ in tcol.scores] == [i for i, _ in jcol.scores] == [
        1, 2, 1]
    assert tnet.iteration == jnet.iteration == 1
    assert ts.rollbacks == 1 and np.isfinite(tnet.score_)
    _assert_close(jnet, tnet)


def test_warn_policy_detects_mid_window_and_carries_on(monkeypatch):
    monkeypatch.setenv(WINDOW, "4")
    jnet, tnet = _pair()
    js, ts = JSentry(policy="warn"), DivergenceSentry(policy="warn")
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jit_, tit = _iters(nan_at=(3,))
    jnet.fit(jit_, epochs=1)
    tnet.fit(tit, epochs=1)
    assert ts.divergences == js.divergences >= 1
    assert ts.rollbacks == js.rollbacks == 0
    assert tnet.iteration == jnet.iteration == 5


@pytest.mark.parametrize("window", [None, "4"])
def test_rollback_through_checkpoint_manager_matches_jax(window, tmp_path,
                                                         monkeypatch):
    """policy="rollback" with a CheckpointManager saved at each epoch end:
    the NaN batch in epoch 2 restores epoch 1's checkpoint; the final
    iteration, epoch and params equal JAX's."""
    if window:
        monkeypatch.setenv(WINDOW, window)
    else:
        monkeypatch.delenv(WINDOW, raising=False)
    jnet, tnet = _pair()
    jm, tm = JManager(str(tmp_path / "j")), CheckpointManager(
        str(tmp_path / "t"))
    js = JSentry(checkpoint_manager=jm, policy="rollback", max_rollbacks=2)
    ts = DivergenceSentry(checkpoint_manager=tm, policy="rollback",
                          max_rollbacks=2)
    jcol, tcol = JCollectScores(), CollectScoresListener()
    jnet.set_listeners(jcol, js)
    tnet.set_listeners(tcol, ts)
    jit_, tit = _iters(nan_at=(7,))
    jnet.fit(jit_, epochs=2, checkpoint_manager=jm)
    tnet.fit(tit, epochs=2, checkpoint_manager=tm)
    assert ts.rollbacks == js.rollbacks == 1
    assert [i for i, _ in tcol.scores] == [i for i, _ in jcol.scores]
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch)
    _assert_close(jnet, tnet)


# ------------------------------------------------------------ per step
def test_budget_exhausted_raises_as_jax():
    jnet, tnet = _pair()
    js = JSentry(policy="skip_batch", max_rollbacks=1)
    ts = DivergenceSentry(policy="skip_batch", max_rollbacks=1)
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jit_, tit = _iters(nan_at=(2, 4))
    with pytest.raises(FloatingPointError) as jerr:
        jnet.fit(jit_, epochs=1)
    with pytest.raises(FloatingPointError) as terr:
        tnet.fit(tit, epochs=1)
    assert str(terr.value) == str(jerr.value)
    assert ts.divergences == js.divergences == 2


def test_non_finite_params_checked_and_on_empty():
    """check_params_every=1 trips on a NaN written into a param (the score
    of that step still finite at the check); with nothing to restore,
    on_empty="raise" raises and "reinit" re-initializes."""
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _conf_json())).init(device="cpu")

    class Poison:
        def iteration_done(self, model, iteration, score):
            if iteration == 2:
                with torch.no_grad():
                    model.params["layer_0"]["W"][0, 0] = float("nan")

    sentry = DivergenceSentry(policy="skip_batch", snapshot_every=0,
                              check_params_every=1)
    net.set_listeners(Poison(), sentry)
    with pytest.raises(FloatingPointError, match="nothing to roll back"):
        net.fit(*_iris_like())
        net.fit(*_iris_like())
    assert not tree_all_finite(net.params)
    sentry.on_empty = "reinit"
    sentry.rollbacks = 0
    sentry.handle_divergence(net, "test")
    assert tree_all_finite(net.params)
    assert tree_all_finite({"a": [np.ones(2), np.arange(3)]})
    assert not tree_all_finite({"a": (np.array([np.inf]),)})


def test_snapshot_restore_round_trip_keeps_live_tensors():
    """A snapshot holds copies (the port updates params in place): after 3
    more steps a restore gives the snapshot's params, state, slots,
    dropout generator, counters and score, bit for bit, in the SAME
    tensors the network held; the next step then equals the step after
    the snapshot."""
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _conf_json(dropout=0.5))).init(device="cpu")
    x, y = _iris_like()
    net.fit(x, y)
    snap = snapshot_training_state(net)
    live = net.params["layer_0"]["W"]
    before = net.get_param_table()
    net.fit(x, y)
    after_one = net.get_param_table()
    net.fit(x, y)
    net.fit(x, y)
    assert not np.array_equal(net.get_param_table()["layer_0/W"],
                              before["layer_0/W"])
    restore_training_state(net, snap)
    assert net.params["layer_0"]["W"] is live
    for k, v in net.get_param_table().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert (net.iteration, net.epoch) == (1, 1)
    assert net.score_ == snap["score"]
    assert torch.equal(net.draws.generator.get_state(), snap["rng"])
    net.fit(x, y)
    for k, v in net.get_param_table().items():
        np.testing.assert_array_equal(v, after_one[k], err_msg=k)
    # the snapshot is reusable: a second restore gives it again
    restore_training_state(net, snap)
    for k, v in net.get_param_table().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


@pytest.mark.parametrize("window", [None, "4"])
def test_spike_norms_match_jax(window, monkeypatch):
    """spike_factor set: the rolling update norms (one per step, one per
    window under windows) equal JAX's within 1e-5 relative, and no
    spike trips on this smooth run."""
    if window:
        monkeypatch.setenv(WINDOW, window)
    else:
        monkeypatch.delenv(WINDOW, raising=False)
    jnet, tnet = _pair()
    js = JSentry(policy="warn", spike_factor=50.0, spike_window=64)
    ts = DivergenceSentry(policy="warn", spike_factor=50.0, spike_window=64)
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jit_, tit = _iters(batch=15)
    jnet.fit(jit_, epochs=2)
    tnet.fit(tit, epochs=2)
    assert len(ts._norms) == len(js._norms) > 4
    np.testing.assert_allclose(list(ts._norms), list(js._norms), rtol=1e-5)
    assert ts.divergences == js.divergences == 0


def test_rollback_window_8_nan_in_second_window_matches_jax(tmp_path,
                                                             monkeypatch):
    """The shape of chip_smoke.py's sentry-charrnn phase at a small width:
    24 batches at K = 8, policy="rollback" with an empty CheckpointManager
    (so the window's snapshot), the NaN batch at position 3 of the second
    window. One divergence, one rollback; the replay stops at iteration
    11, the window restarts from 8, and the third window is iterations 9
    to 16: the iteration lists pinned here are the JAX package's."""
    monkeypatch.setenv(WINDOW, "8")
    x, y = _iris_like()
    x, y = x[:144], y[:144]
    jnet, tnet = _pair()
    js = JSentry(checkpoint_manager=JManager(str(tmp_path / "j")),
                 policy="rollback", max_rollbacks=2)
    ts = DivergenceSentry(checkpoint_manager=CheckpointManager(
        str(tmp_path / "t")), policy="rollback", max_rollbacks=2)
    jcol, tcol = JCollectScores(), CollectScoresListener()
    jnet.set_listeners(jcol, js)
    tnet.set_listeners(tcol, ts)
    jnet.fit(ChaosDataSetIterator(jits.ListDataSetIterator(
        jds.DataSet(x, y), batch=6), nan_at=(11,)), epochs=1)
    tnet.fit(NanAt(ListDataSetIterator(DataSet(x, y), batch=6), (11,)),
             epochs=1)
    want = list(range(1, 12)) + list(range(9, 17))
    assert [i for i, _ in jcol.scores] == want
    assert [i for i, _ in tcol.scores] == want
    assert (ts.divergences, ts.rollbacks) == (js.divergences,
                                              js.rollbacks) == (1, 1)
    assert tnet.iteration == jnet.iteration == 16
    _assert_close(jnet, tnet)


def test_rollback_window_8_through_checkpoint_listener_matches_jax(
        tmp_path, monkeypatch):
    """sentry-charrnn's rollback as chip_smoke.py runs it: the same 24
    batches at K = 8 with a CheckpointListener saving every 8 iterations
    (so at each window's end) and the sentry keeping no snapshot
    (snapshot_every=0), so the trip at iteration 11 can only restore the
    checkpoint of iteration 8 through the manager. The iteration lists,
    the saves and the params equal the JAX package's."""
    monkeypatch.setenv(WINDOW, "8")
    x, y = _iris_like()
    x, y = x[:144], y[:144]
    jnet, tnet = _pair()
    jcm, tcm = JManager(str(tmp_path / "j")), CheckpointManager(
        str(tmp_path / "t"))
    js = JSentry(checkpoint_manager=jcm, policy="rollback", max_rollbacks=2,
                 snapshot_every=0)
    ts = DivergenceSentry(checkpoint_manager=tcm, policy="rollback",
                          max_rollbacks=2, snapshot_every=0)
    jcol, tcol = JCollectScores(), CollectScoresListener()
    jnet.set_listeners(jcol, JCkptListener(jcm, save_every_n_iterations=8),
                       js)
    tnet.set_listeners(tcol, CheckpointListener(tcm,
                                                save_every_n_iterations=8),
                       ts)
    jnet.fit(ChaosDataSetIterator(jits.ListDataSetIterator(
        jds.DataSet(x, y), batch=6), nan_at=(11,)), epochs=1)
    tnet.fit(NanAt(ListDataSetIterator(DataSet(x, y), batch=6), (11,)),
             epochs=1)
    want = list(range(1, 12)) + list(range(9, 17))
    assert [i for i, _ in jcol.scores] == want
    assert [i for i, _ in tcol.scores] == want
    assert (ts.divergences, ts.rollbacks) == (js.divergences,
                                              js.rollbacks) == (1, 1)
    assert ts._snapshot is None
    assert [m["step"] for m in tcm.manifests()] == [
        m["step"] for m in jcm.manifests()]
    assert tnet.iteration == jnet.iteration == 16
    _assert_close(jnet, tnet)
