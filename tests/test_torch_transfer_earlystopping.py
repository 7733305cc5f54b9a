"""Transfer learning, the Frozen layer and early stopping of the port
against the JAX package: the JAX cases of tests/test_transfer_earlystopping
run in both packages on the same weights (carried by
`interop.params_from_jax`), Frozen through JSON and checkpoint zips of
either package, the frozen params out of the gradient, Frozen in a graph
(updated in both packages, ROADMAP C.11), and the early-stopping trainers'
results and events.

Tolerances: params after Adam or Nesterovs steps 1e-5 absolute and scores
1e-5 relative (tests/test_torch_training.py's Dense fits); what a step
must leave alone (frozen params, BatchNorm statistics) bit for bit.
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iterators as jits
from deeplearning4j_tpu.earlystopping import core as jes
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models import serialization as jser
from deeplearning4j_tpu.models import transfer as jtransfer
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu.nn.layers import Output as JOutput
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import (
    ComputationGraph,
    MultiLayerNetwork,
    restore_model,
    write_model,
)
from deeplearning4j_tpu_torch.models import _training as tr
from deeplearning4j_tpu_torch.models import transfer as ttransfer
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
    BatchNorm,
    Conv2D,
    Dense,
    Frozen,
    Output,
    Subsampling2D,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer


def _iris(seed=12345):
    """The JAX tests' iris_like (150 x 4, three classes), with the classes
    overlapping, so that the losses stay near 1 and a relative tolerance
    on them means something."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.0, (3, 4))
    ids = rng.integers(0, 3, 150)
    x = (centers[ids] + rng.normal(0, 1.2, (150, 4))).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[ids]


def _conf_json(seed=4):
    return NeuralNetConfiguration(
        seed=seed, updater=updaters.Adam(learning_rate=0.05)).list([
            Dense(n_out=16, activation="relu"),
            Dense(n_out=8, activation="relu"),
            Output(n_out=3, loss="mcxent")]).set_input_type(
        it.feed_forward(4)).to_json()


def _carry(jnet, tnet):
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    return tnet


def _pair(conf_json):
    jnet = JMLN(JConf.from_json(conf_json)).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf_json)).init(device="cpu")
    return jnet, _carry(jnet, tnet)


def _its(x, y, batch):
    return (ListDataSetIterator(DataSet(x, y), batch=batch),
            jits.ListDataSetIterator(jds.DataSet(x, y), batch=batch))


def _close(tnet, jnet, tol=1e-5, keys=None):
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    tt = tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in keys or jt:
        np.testing.assert_allclose(tt[k], jt[k], atol=tol, err_msg=k)


def _trained_pair(epochs):
    jnet, tnet = _pair(_conf_json())
    x, y = _iris()
    ti, ji = _its(x, y, 50)
    jnet.fit(ji, epochs=epochs)
    tnet.fit(ti, epochs=epochs)
    return jnet, tnet


# ---------------------------------------------------------------- transfer
def test_transfer_freeze_keeps_frozen_params_as_jax():
    jnet, tnet = _trained_pair(2)
    jnew = jtransfer.TransferLearning(jnet).set_feature_extractor(0).build()
    tnew = ttransfer.TransferLearning(tnet).set_feature_extractor(0).build()
    assert isinstance(tnew.layers[0], Frozen) and tnew.device == tnet.device
    assert [l.to_json() for l in tnew.layers] == \
        [l.to_json() for l in jnew.layers]
    before = tnew.get_param_table()
    x, y = _iris()
    ti, ji = _its(x, y, 50)
    jnew.fit(ji, epochs=3)
    tnew.fit(ti, epochs=3)
    after = tnew.get_param_table()
    np.testing.assert_array_equal(after["layer_0/W"], before["layer_0/W"])
    np.testing.assert_array_equal(after["layer_0/b"], before["layer_0/b"])
    assert not np.allclose(after["layer_1/W"], before["layer_1/W"])
    assert abs(tnew.score_ - jnew.score_) <= 1e-5 * abs(jnew.score_)
    _close(tnew, jnew)
    # the source network is untouched by its copy's training
    np.testing.assert_array_equal(tnet.get_param_table()["layer_1/W"],
                                  before["layer_1/W"])


def test_transfer_replace_output_as_jax():
    jnet, tnet = _trained_pair(1)
    jnew = (jtransfer.TransferLearning(jnet).set_feature_extractor(1)
            .remove_output_layer()
            .add_layer(JOutput(n_out=5, loss="mcxent")).build())
    tnew = (ttransfer.TransferLearning(tnet).set_feature_extractor(1)
            .remove_output_layer()
            .add_layer(Output(n_out=5, loss="mcxent")).build())
    x, _ = _iris()
    assert tuple(tnew.output(x).shape) == (150, 5)
    np.testing.assert_array_equal(tnew.get_param_table()["layer_0/W"],
                                  tnet.get_param_table()["layer_0/W"])
    # the new Output's draw differs between the packages: carry JAX's
    _carry(jnew, tnew)
    y5 = np.eye(5, dtype=np.float32)[np.random.default_rng(3).integers(
        0, 5, 150)]
    ti, ji = _its(x, y5, 50)
    jnew.fit(ji)
    tnew.fit(ti)
    assert abs(tnew.score_ - jnew.score_) <= 1e-5 * abs(jnew.score_)
    _close(tnew, jnew)
    np.testing.assert_allclose(tnew.output(x).numpy(), jnew.output(x),
                               atol=1e-6)


def test_transfer_nout_replace_as_jax():
    jnet, tnet = _pair(_conf_json())
    jnew = jtransfer.TransferLearning(jnet).n_out_replace(1, 12).build()
    tnew = ttransfer.TransferLearning(tnet).n_out_replace(1, 12).build()
    assert tuple(tnew.params["layer_1"]["W"].shape) == (16, 12)
    assert tuple(tnew.params["layer_2"]["W"].shape) == (12, 3)
    np.testing.assert_array_equal(tnew.get_param_table()["layer_0/W"],
                                  tnet.get_param_table()["layer_0/W"])
    _carry(jnew, tnew)
    x, _ = _iris()
    np.testing.assert_allclose(tnew.output(x).numpy(), jnew.output(x),
                               atol=1e-6)


def test_fine_tune_configuration_as_jax():
    jnet, tnet = _pair(_conf_json())
    jnew = (jtransfer.TransferLearning(jnet).fine_tune_configuration(
        jtransfer.FineTuneConfiguration(learning_rate=1e-4)).build())
    tnew = (ttransfer.TransferLearning(tnet).fine_tune_configuration(
        ttransfer.FineTuneConfiguration(learning_rate=1e-4)).build())
    assert tnew.conf.defaults.updater.learning_rate == \
        jnew.conf.defaults.updater.learning_rate == 1e-4
    assert tnet.conf.defaults.updater.learning_rate == 0.05
    ft = ttransfer.FineTuneConfiguration(
        updater=updaters.Nesterovs(learning_rate=5e-5, momentum=0.9),
        seed=7, l2=1e-3)
    jft = jtransfer.FineTuneConfiguration(
        updater=jupd.Nesterovs(learning_rate=5e-5, momentum=0.9), seed=7,
        l2=1e-3)
    t2 = ttransfer.TransferLearning(tnet).fine_tune_configuration(ft).build()
    j2 = jtransfer.TransferLearning(jnet).fine_tune_configuration(jft).build()
    assert t2.conf.to_json() == j2.conf.to_json()


def test_transfer_helper_featurize_as_jax_and_as_the_frozen_fit():
    """featurize then fit_featurized trains the tail as the JAX helper
    does, and as a fit of the whole frozen network does."""
    jnet, tnet = _pair(_conf_json())
    jnew = jtransfer.TransferLearning(jnet).set_feature_extractor(0).build()
    tnew = ttransfer.TransferLearning(tnet).set_feature_extractor(0).build()
    whole = ttransfer.TransferLearning(tnet).set_feature_extractor(0).build()
    jh, th = (jtransfer.TransferLearningHelper(jnew),
              ttransfer.TransferLearningHelper(tnew))
    assert th.frozen_until == jh.frozen_until == 0
    x, y = _iris()
    jf, tf = jh.featurize(jds.DataSet(x, y)), th.featurize(DataSet(x, y))
    assert tuple(tf.features.shape) == (150, 16)
    np.testing.assert_allclose(tf.features.numpy(), jf.features, atol=1e-6)
    tail = th.unfrozen_network()
    assert tail.device == tnew.device and len(tail.layers) == 2
    jh.fit_featurized(jf, epochs=2)
    th.fit_featurized(tf, epochs=2)
    _close(tnew, jnew)
    whole.fit(DataSet(x, y), epochs=2)
    a, b = tnew.get_param_table(), whole.get_param_table()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)


def test_frozen_params_are_no_leaves_of_the_gradient():
    """The frozen layers' params record no gradient, so the backward ends
    at the first trainable layer; their update entries are empty."""
    _, tnet = _pair(_conf_json())
    new = ttransfer.TransferLearning(tnet).set_feature_extractor(1).build()
    x, y = _iris()
    new.fit(DataSet(x, y))
    for k in ("layer_0", "layer_1"):
        assert not any(t.requires_grad for _, t in
                       tr.flat_items(new.params[k]))
    score, _, grads = tr.value_and_grad(
        lambda: new._loss(new.params, torch.from_numpy(x),
                          torch.from_numpy(y)),
        new.params, frozen=new._frozen_keys())
    assert grads["layer_0"] == {} and grads["layer_1"] == {}
    assert set(grads["layer_2"]) == {"W", "b"}
    assert score.grad_fn is not None


def test_frozen_conv_and_batchnorm_as_jax():
    """A frozen Conv2D (HWIO at rest, OIHW inside) and a frozen BatchNorm
    (its running statistics in training, never updated) in a small CNN,
    3 Nesterovs steps against the JAX package."""
    conf_json = NeuralNetConfiguration(
        seed=2, updater=updaters.Nesterovs(learning_rate=0.05,
                                           momentum=0.9)).list([
            Conv2D(kernel_size=(3, 3), n_out=4, activation="relu"),
            BatchNorm(),
            Subsampling2D(kernel_size=(2, 2), stride=(2, 2)),
            Dense(n_out=6, activation="tanh"),
            Output(n_out=3, loss="mcxent")]).set_input_type(
        it.convolutional(8, 8, 2)).to_json()
    jnet, tnet = _pair(conf_json)
    rng = np.random.default_rng(5)
    state = jax.tree_util.tree_map(np.asarray, jnet.state)
    state["layer_1"] = {"mean": rng.normal(0, 0.2, 4).astype(np.float32),
                        "var": rng.uniform(0.5, 2, 4).astype(np.float32)}
    jnet.state = state
    _carry(jnet, tnet)
    jnew = jtransfer.TransferLearning(jnet).set_feature_extractor(1).build()
    tnew = ttransfer.TransferLearning(tnet).set_feature_extractor(1).build()
    x = rng.normal(0, 1, (6, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    before = tnew.get_param_table()
    for _ in range(3):
        jnew.fit(jds.DataSet(x, y))
        tnew.fit(DataSet(x, y))
        assert abs(tnew.score_ - jnew.score_) <= 1e-5 * abs(jnew.score_)
    _close(tnew, jnew)
    after = tnew.get_param_table()
    for k in ("layer_0/W", "layer_0/b", "layer_1/gamma", "layer_1/beta"):
        np.testing.assert_array_equal(after[k], before[k])
    for k in ("mean", "var"):
        np.testing.assert_array_equal(tnew.state["layer_1"][k].numpy(),
                                      state["layer_1"][k])


def test_frozen_in_a_graph_is_updated_as_in_jax():
    """ROADMAP C.11: the JAX graph step has no frozen check, so a Frozen
    layer vertex runs with train=False and is still updated; the port
    follows it. Pinned in both packages."""
    g = NeuralNetConfiguration(seed=8, updater=updaters.Sgd(
        learning_rate=0.1)).graph().add_inputs("in")
    g.add_layer("f", Frozen(underlying=Dense(n_out=5, activation="tanh")),
                "in")
    g.add_layer("out", Output(n_out=3, loss="mcxent"), "f")
    g.set_outputs("out")
    g.set_input_types(it.feed_forward(4))
    conf_json = g.to_json()
    jnet = JCG(JGConf.from_json(conf_json)).init()
    tnet = _carry(jnet, ComputationGraph(
        ComputationGraphConfiguration.from_json(conf_json)).init(
        device="cpu"))
    x, y = _iris()
    w0 = tnet.get_param_table()["f/W"]
    for _ in range(2):
        jnet.fit(jds.DataSet(x, y))
        tnet.fit(DataSet(x, y))
    assert not np.allclose(np.asarray(jnet.get_param_table()["f/W"]), w0)
    assert not np.allclose(tnet.get_param_table()["f/W"], w0)
    _close(tnet, jnet)


def test_frozen_json_crosses_packages():
    t = Frozen(underlying=Dense(n_out=5, activation="tanh", l2=0.1))
    j = JLayer.from_json(json.loads(json.dumps(t.to_json())))
    assert type(j).__name__ == "Frozen" and j.to_json() == t.to_json()
    back = Layer.from_json(j.to_json())
    assert isinstance(back, Frozen) and isinstance(back.inner, Dense)
    assert back.to_json() == t.to_json()
    assert back.regularizable({"W": torch.ones(2)}) == {}
    _, tnet = _pair(_conf_json())
    new = ttransfer.TransferLearning(tnet).set_feature_extractor(0).build()
    conf = MultiLayerConfiguration.from_json(new.conf.to_json())
    assert JConf.from_json(new.conf.to_json()).to_json() == conf.to_json()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frozen_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint holding Frozen layers, written by one package, restored
    and run by the other: the same outputs, and one more step each from
    the restored state agrees."""
    jnet, tnet = _trained_pair(1)
    jnew = jtransfer.TransferLearning(jnet).set_feature_extractor(0).build()
    tnew = ttransfer.TransferLearning(tnet).set_feature_extractor(0).build()
    x, y = _iris()
    jnew.fit(jds.DataSet(x, y))
    tnew.fit(DataSet(x, y))
    path = str(tmp_path / "frozen.zip")
    if writer == "jax":
        jser.write_model(jnew, path)
        src = jnew
    else:
        write_model(tnew, path)
        src = tnew
    tres = restore_model(path, device="cpu")
    jres = jser.restore_model(path)
    assert isinstance(tres.layers[0], Frozen)
    assert type(jres.layers[0]).__name__ == "Frozen"
    want = (src.output(x).numpy() if writer == "port"
            else np.asarray(src.output(x)))
    np.testing.assert_allclose(tres.output(x).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jres.output(x)), want, atol=1e-6)
    jres.fit(jds.DataSet(x, y))
    tres.fit(DataSet(x, y))
    assert tres.iteration == jres.iteration == 2
    _close(tres, jres)
    np.testing.assert_array_equal(tres.get_param_table()["layer_0/W"],
                                  np.asarray(jres.get_param_table()
                                             ["layer_0/W"]))


# ---------------------------------------------------------------- early stop
class Recorder:
    def __init__(self):
        self.events = []

    def on_fit_start(self, model):
        self.events.append("fit_start")

    def on_epoch_start(self, model, epoch):
        self.events.append(("epoch_start", epoch))

    def on_epoch_end(self, model, epoch):
        self.events.append(("epoch_end", epoch))

    def on_fit_end(self, model):
        self.events.append("fit_end")

    def iteration_done(self, model, iteration, score):
        self.events.append(iteration)

    def on_forward_pass(self, model, activations):
        pass

    def on_gradient_calculation(self, model):
        pass


def _es_run(pkg, net, x, y, cfg_kwargs, batch=50, held=75):
    ds_cls = DataSet if pkg is tes else jds.DataSet
    it_cls = (ListDataSetIterator if pkg is tes
              else jits.ListDataSetIterator)
    kw = dict(cfg_kwargs)
    if kw.pop("loss_calculator", True):
        kw["score_calculator"] = pkg.DataSetLossCalculator(
            it_cls(ds_cls(x, y), batch=held))
    cfg = pkg.EarlyStoppingConfiguration(**kw)
    rec = Recorder()
    net.set_listeners(rec)
    result = pkg.EarlyStoppingTrainer(cfg, net,
                                      it_cls(ds_cls(x, y), batch=batch)).fit()
    return result, rec.events


def _same_result(t, j):
    assert t.termination_reason == j.termination_reason
    assert t.termination_details == j.termination_details
    assert t.best_model_epoch == j.best_model_epoch
    assert t.total_epochs == j.total_epochs
    assert sorted(t.score_vs_epoch) == sorted(j.score_vs_epoch)
    for e, s in j.score_vs_epoch.items():
        if np.isfinite(s):
            assert abs(t.score_vs_epoch[e] - s) <= 1e-5 * abs(s), e
        else:
            assert not np.isfinite(t.score_vs_epoch[e])


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_early_stopping_max_epochs_as_jax(tmp_path, saver):
    jnet, tnet = _pair(_conf_json())
    x, y = _iris()

    def cfg(pkg):
        s = (pkg.InMemoryModelSaver() if saver == "memory"
             else pkg.LocalFileModelSaver(str(tmp_path / pkg.__name__)))
        return dict(model_saver=s, epoch_termination_conditions=[
            pkg.MaxEpochsTerminationCondition(4)])

    jres, jev = _es_run(jes, jnet, x, y, cfg(jes))
    tres, tev = _es_run(tes, tnet, x, y, cfg(tes))
    _same_result(tres, jres)
    assert tres.total_epochs == 4
    assert tres.termination_details == "MaxEpochsTerminationCondition"
    # fit once per epoch: the lifecycle events repeat per epoch, as JAX's
    assert tev == jev
    assert tev[:6] == ["fit_start", ("epoch_start", 0), 1, 2, 3,
                       ("epoch_end", 0)]
    best = tres.get_best_model()
    assert best.device == tnet.device
    _close(best, jres.get_best_model())
    assert tres.best_model_score <= max(tres.score_vs_epoch.values())


def test_early_stopping_score_improvement_as_jax():
    jnet, tnet = _pair(_conf_json())
    x, y = _iris()

    def cfg(pkg):
        return dict(epoch_termination_conditions=[
            pkg.ScoreImprovementEpochTerminationCondition(
                max_epochs_without_improvement=2, min_improvement=10.0),
            pkg.MaxEpochsTerminationCondition(50)])

    jres, _ = _es_run(jes, jnet, x, y, cfg(jes))
    tres, _ = _es_run(tes, tnet, x, y, cfg(tes))
    _same_result(tres, jres)
    assert tres.total_epochs <= 5
    assert tres.termination_details == \
        "ScoreImprovementEpochTerminationCondition"


def test_early_stopping_invalid_score_aborts_as_jax():
    jnet, tnet = _pair(_conf_json(seed=1))
    for net in (jnet, tnet):
        for u in net._updaters:
            u.learning_rate = 1e18
    x, y = _iris()

    def cfg(pkg):
        return dict(loss_calculator=False,
                    iteration_termination_conditions=[
                        pkg.InvalidScoreIterationTerminationCondition()],
                    epoch_termination_conditions=[
                        pkg.MaxEpochsTerminationCondition(100)])

    jres, jev = _es_run(jes, jnet, x, y, cfg(jes), batch=10)
    tres, tev = _es_run(tes, tnet, x, y, cfg(tes), batch=10)
    assert tres.termination_reason == jres.termination_reason == \
        "IterationTerminationCondition"
    assert tres.termination_details == \
        "InvalidScoreIterationTerminationCondition"
    assert tres.total_epochs == jres.total_epochs < 100
    assert tev == jev


def test_early_stopping_graph_trainer_and_classification_score():
    """EarlyStoppingGraphTrainer on a graph, scored by -accuracy, against
    the JAX trainer on the same graph."""
    g = NeuralNetConfiguration(seed=3, updater=updaters.Adam(
        learning_rate=0.02)).graph().add_inputs("in")
    g.add_layer("d", Dense(n_out=6, activation="tanh"), "in")
    g.add_layer("out", Output(n_out=3, loss="mcxent"), "d")
    g.set_outputs("out")
    g.set_input_types(it.feed_forward(4))
    conf_json = g.to_json()
    jnet = JCG(JGConf.from_json(conf_json)).init()
    tnet = _carry(jnet, ComputationGraph(
        ComputationGraphConfiguration.from_json(conf_json)).init(
        device="cpu"))
    x, y = _iris()
    out = []
    for pkg, net, it_cls, ds_cls in (
            (jes, jnet, jits.ListDataSetIterator, jds.DataSet),
            (tes, tnet, ListDataSetIterator, DataSet)):
        cfg = pkg.EarlyStoppingConfiguration(
            score_calculator=pkg.ClassificationScoreCalculator(
                it_cls(ds_cls(x, y), batch=150)),
            epoch_termination_conditions=[
                pkg.MaxEpochsTerminationCondition(3),
                pkg.BestScoreEpochTerminationCondition(-2.0)],
            save_last_model=True)
        out.append(pkg.EarlyStoppingGraphTrainer(
            cfg, net, it_cls(ds_cls(x, y), batch=50)).fit())
    _same_result(out[1], out[0])
    assert out[1].get_best_model().device == tnet.device


def test_iteration_conditions_as_jax():
    for t, j, args in (
            (tes.MaxScoreIterationTerminationCondition,
             jes.MaxScoreIterationTerminationCondition, (2.0,)),
            (tes.InvalidScoreIterationTerminationCondition,
             jes.InvalidScoreIterationTerminationCondition, ())):
        a, b = t(*args), j(*args)
        a.initialize()
        b.initialize()
        for s in (0.5, 3.0, float("nan"), float("inf")):
            assert a.terminate(s) == b.terminate(s)
    m = tes.MaxTimeIterationTerminationCondition(max_seconds=0.0)
    m.initialize()
    assert m.terminate(0.0)


def test_savers_restore_onto_the_saved_device_or_the_given_one(tmp_path):
    _, tnet = _pair(_conf_json())
    for saver in (tes.InMemoryModelSaver(),
                  tes.LocalFileModelSaver(str(tmp_path))):
        assert saver.get_best(device="cpu") is None
        saver.save_best(tnet)
        best = saver.get_best()
        assert best.device == torch.device("cpu")
        a, b = best.get_param_table(), tnet.get_param_table()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    tes.LocalFileModelSaver(str(tmp_path)).save_latest(tnet)
    assert sorted(os.listdir(tmp_path)) == ["bestModel.zip",
                                            "latestModel.zip"]
    fresh = tes.LocalFileModelSaver(str(tmp_path))
    assert fresh.get_best(device="cpu").iteration == tnet.iteration


def test_transfer_build_keeps_layers_of_the_source_config():
    _, tnet = _pair(_conf_json())
    before = copy.deepcopy(tnet.conf.to_json())
    ttransfer.TransferLearning(tnet).set_feature_extractor(1).n_out_replace(
        0, 20).build()
    assert tnet.conf.to_json() == before
