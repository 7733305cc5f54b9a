"""The port's ParallelWrapper (deeplearning4j_tpu_torch/parallel/) against
the JAX package's ParallelWrapper on its 8-device virtual CPU mesh and
against the port's single-process fit, on the same numpy-seeded inputs
and the same weights (the JAX network's, carried over by interop).

The port runs one process per rank: each case spawns its ranks as
processes of tests/torch_dp_worker.py (which imports no JAX) over gloo with
a file:// rendezvous in the test's tmp_path, while this process computes
the references. The JAX wrapper at N < 8 ranks runs on the first N
virtual devices (its build_mesh needs exactly spec.total() devices).

Tolerances are the JAX tests' own (tests/test_parallel.py): params 2e-5
absolute (test_dp_matches_single_device), per-window tBPTT scores rtol 2e-4
/ atol 2e-5 and params 3e-5 (test_tbptt_dp_matches_single_device); where
the JAX test asserts only learning, the port's parity bounds
(test_torch_graph_training.py, test_torch_dropout.py): params 1e-5
absolute, scores 1e-5 relative, running stats and updater slots 1e-4 of
each leaf's largest magnitude. Every rank ends with the same params, bit
for bit.
"""
import itertools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    BatchNorm,
    CenterLossOutput,
    Conv2D,
    Dense,
    GravesLSTM,
    Output,
    RnnOutput,
    Subsampling2D,
    Yolo2Output,
)
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ParallelWrapper,
    build_mesh,
    init_process_group,
)
from deeplearning4j_tpu_torch.parallel.wrapper import pad_batch
from torch_dp_worker import Tape, results
from torch_graphs import small_resnet_json
from torch_keys import JaxKeys

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dp_worker.py")
_RUN = itertools.count()


# ------------------------------------------------------------ harness
def spawn(tmp_path, world, **spec):
    """Starts `world` rank processes on `spec`; returns a function that
    waits for them and gives each rank's results."""
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

    def wait(timeout=300):
        try:
            logs = [p.communicate(timeout=timeout)[0].decode()
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
        if spec.get("refusals"):
            return [json.load(open(o)) for o in outs]
        return [dict(np.load(o)) for o in outs]

    return wait


def save_data(tmp_path, name, x, y, fm=None, lm=None):
    path = str(tmp_path / f"{name}.npz")
    arrays = dict(x=x, y=y)
    if fm is not None:
        arrays["fm"] = fm
    if lm is not None:
        arrays["lm"] = lm
    np.savez(path, **arrays)
    return path


def save_weights(tmp_path, jnet):
    """The JAX network's params and running state as "param/key/path" and
    "state/key/path" entries."""
    out = {}
    for kind, tree in (("param", jnet.params), ("state", jnet.state)):
        for path, leaf in flat_items(jax.tree_util.tree_map(np.asarray,
                                                            tree)):
            out[f"{kind}/{path}"] = leaf
    path = str(tmp_path / "weights.npz")
    np.savez(path, **out)
    return path


class Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, net, iteration, score):
        self.scores.append(float(score))

    def on_epoch_start(self, net, epoch):
        pass

    def on_epoch_end(self, net, epoch):
        pass


def jax_net(kind, conf_json):
    return (JCG(JGConf.from_json(conf_json)) if kind == "cg"
            else JMLN(JConf.from_json(conf_json))).init()


def port_net(kind, conf_json, jnet):
    net = (ComputationGraph(ComputationGraphConfiguration.from_json(
        conf_json)) if kind == "cg" else MultiLayerNetwork(
        MultiLayerConfiguration.from_json(conf_json))).init(device="cpu")
    interop.params_from_jax(net, jax.tree_util.tree_map(np.asarray,
                                                        jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    return net


def jax_fit(jnet, world, data, batch, epochs, shuffle=False):
    """The JAX ParallelWrapper over the first `world` virtual devices."""
    log = Scores()
    jnet.set_listeners(log)
    mesh = jbuild_mesh(JMeshSpec(data=world), devices=jax.devices()[:world])
    JWrapper(jnet, mesh=mesh).fit(
        JListIterator(jds.DataSet(*data), batch=batch,
                      shuffle_each_epoch=shuffle), epochs=epochs)
    return log.scores


def port_fit(net, data, batch, epochs, shuffle=False):
    """The port's single-process fit."""
    log = Scores()
    net.set_listeners(log)
    net.fit(ListDataSetIterator(DataSet(*data), batch=batch,
                                shuffle_each_epoch=shuffle), epochs=epochs)
    return log.scores


def jax_results(jnet):
    out = {}
    for key, v in jnet.get_param_table().items():
        v = v.item() if isinstance(v, np.ndarray) and v.dtype == object \
            else v
        leaves = flat_items(v) if isinstance(v, dict) else [("", v)]
        for path, leaf in leaves:
            out[f"param/{key}" + (f"/{path}" if path else "")] = \
                np.asarray(leaf)
    for path, leaf in flat_items(jax.tree_util.tree_map(np.asarray,
                                                        jnet.state)):
        out[f"state/{path}"] = leaf
    return out


def max_err(got, want, prefix, rel=False):
    """The largest |got - want| over the entries under `prefix` (relative
    to each leaf's largest magnitude with `rel`); the same keys on both
    sides."""
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got if k.startswith(prefix))
    worst = 0.0
    for k in keys:
        d = float(np.abs(np.asarray(got[k], np.float64)
                         - np.asarray(want[k], np.float64)).max())
        if rel:
            d /= max(float(np.abs(want[k]).max()), 1e-30)
        worst = max(worst, d)
    return worst


def same_on_every_rank(ranks):
    for k in ranks[0]:
        if k.startswith(("param/", "slot/", "state/")):
            for r in ranks[1:]:
                assert np.array_equal(r[k], ranks[0][k]), k


# ------------------------------------------------------------ nets
def _dense_conf(seed=11, lr=0.05):
    return NeuralNetConfiguration(
        seed=seed, updater=updaters.Adam(learning_rate=lr)).list([
            Dense(n_out=32, activation="relu"),
            Output(n_out=3, loss="mcxent"),
        ]).set_input_type(it.feed_forward(8)).to_json()


def _ff_data(seed, n, f=8, c=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    ids = rng.integers(0, c, n)
    x[:, 0] += 2.0 * ids
    return x, np.eye(c, dtype=np.float32)[ids]


def _tbptt_conf(seed=9):
    return NeuralNetConfiguration(
        seed=seed, updater=updaters.Adam(learning_rate=5e-3),
        backprop_type="tbptt", tbptt_fwd_length=8).list([
            LSTM(n_out=24, activation="tanh"),
            RnnOutput(n_out=10, loss="mcxent"),
        ]).set_input_type(it.recurrent(10, 32)).to_json()


def _merge_graph_conf():
    return ComputationGraphConfiguration(
        defaults=NeuralNetConfiguration(
            seed=3, updater=updaters.Adam(learning_rate=0.02))) \
        .add_inputs("in") \
        .add_layer("a", Dense(n_out=12, activation="relu"), "in") \
        .add_layer("b", Dense(n_out=12, activation="tanh"), "in") \
        .add_vertex("m", MergeVertex(), "a", "b") \
        .add_layer("out", Output(n_out=3, loss="mcxent"), "m") \
        .set_outputs("out").set_input_types(it.feed_forward(8)).to_json()


def _masked_graph_conf():
    """in -> GravesLSTM(24) -> RnnOutput(10), tBPTT windows of 8."""
    return ComputationGraphConfiguration(
        defaults=NeuralNetConfiguration(
            seed=9, updater=updaters.Adam(learning_rate=5e-3),
            backprop_type="tbptt", tbptt_fwd_length=8)) \
        .add_inputs("in") \
        .add_layer("lstm", GravesLSTM(n_out=24, activation="tanh"), "in") \
        .add_layer("out", RnnOutput(n_out=10, loss="mcxent"), "lstm") \
        .set_outputs("out").set_input_types(it.recurrent(10, 32)).to_json()


YOLO_BOXES, YOLO_CLASSES = [[1.0, 1.5], [2.5, 1.2]], 3


def _yolo_conf():
    """conv + leaky BatchNorm + pool + 1x1 conv into Yolo2Output: a 4x5
    grid of 2 anchors at 8x10x3."""
    n_out = len(YOLO_BOXES) * (5 + YOLO_CLASSES)
    return NeuralNetConfiguration(
        seed=6, updater=updaters.Adam(learning_rate=1e-2)).list([
            Conv2D(kernel_size=(3, 3), n_out=6, convolution_mode="same",
                   has_bias=False),
            BatchNorm(activation="leakyrelu"),
            Subsampling2D(kernel_size=(2, 2), stride=(2, 2)),
            Conv2D(kernel_size=(1, 1), n_out=n_out, convolution_mode="same"),
            Yolo2Output(boxes=YOLO_BOXES, num_classes=YOLO_CLASSES),
        ]).set_input_type(it.convolutional(8, 10, 3)).to_json()


def _yolo_data(seed, n, grid=(4, 5)):
    """n seeded 8x10x3 images and Yolo2Output labels of one box each,
    written into the cell of its center."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 10, 3)).astype(np.float32)
    H, W = grid
    y = np.zeros((n, H, W, 4 + YOLO_CLASSES), np.float32)
    for i in range(n):
        cx, cy = rng.uniform(0.05, 0.95, 2)
        w, h = rng.uniform(0.1, 0.5, 2)
        r, c = min(int(cy * H), H - 1), min(int(cx * W), W - 1)
        y[i, r, c, :4] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
        y[i, r, c, 4 + rng.integers(YOLO_CLASSES)] = 1.0
    return x, y


def _center_loss_graph_conf():
    """in -> Dense(12, tanh) -> CenterLossOutput(3): a one-in, one-out
    graph, as zoo FaceNetNN4Small2 is."""
    return ComputationGraphConfiguration(
        defaults=NeuralNetConfiguration(
            seed=5, updater=updaters.Adam(learning_rate=0.02))) \
        .add_inputs("in") \
        .add_layer("emb", Dense(n_out=12, activation="tanh"), "in") \
        .add_layer("out", CenterLossOutput(n_out=3, loss="mcxent",
                                           alpha=0.5, lambda_=0.1), "emb") \
        .set_outputs("out").set_input_types(it.feed_forward(8)).to_json()


def run_case(tmp_path, kind, conf, world, data, batch, epochs,
             shuffle=False, **extra):
    """The port's `world` ranks (spawned), the JAX wrapper and the port's
    single process, all from the JAX network's weights. Returns (ranks,
    jax results, jax scores, port results, port scores)."""
    jnet = jax_net(kind, conf)
    tnet = port_net(kind, conf, jnet)
    wait = spawn(tmp_path, world, kind=kind, conf=conf,
                 weights=save_weights(tmp_path, jnet),
                 data=save_data(tmp_path, "data", *data), batch=batch,
                 epochs=epochs, shuffle=shuffle, **extra)
    copy = [None if a is None else a.copy() for a in data]
    t_scores = port_fit(tnet, copy, batch, epochs, shuffle)
    j_scores = jax_fit(jnet, world, [None if a is None else a.copy()
                                     for a in data], batch, epochs, shuffle)
    ranks = wait()
    same_on_every_rank(ranks)
    return (ranks, jax_results(jnet), j_scores,
            results(tnet, t_scores), t_scores)


# ------------------------------------------------------------ cases
@pytest.mark.parametrize("world", [2, 4])
def test_dense_mln_matches_jax_and_single_process(tmp_path, world):
    """JAX test_dp_matches_single_device at N ranks: one global batch of
    64, 3 epochs, Adam."""
    conf = _dense_conf()
    ranks, jr, js, tr_, ts = run_case(tmp_path, "mln", conf, world,
                                      (*_ff_data(0, 64), None, None), 64, 3)
    r0 = ranks[0]
    assert max_err(r0, jr, "param/") <= 2e-5
    assert max_err(r0, tr_, "param/") <= 2e-5
    assert max_err(r0, tr_, "slot/", rel=True) <= 1e-4
    np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=1e-5)
    assert int(r0["iteration"]) == 3 and int(r0["epoch"]) == 3
    # one float32 bucket per step: every gradient and the score
    n_params = sum(v.size for k, v in r0.items() if k.startswith("param/"))
    assert int(r0["collectives"]) == int(r0["steps"]) == 3
    assert int(r0["reduced_bytes"]) == 3 * 4 * (n_params + 1)


@pytest.mark.parametrize("masked", [False, True])
def test_uneven_tail_batch_padded(tmp_path, masked):
    """JAX test_uneven_tail_batch_padded at 4 ranks: 102 rows in batches
    of 64 leave a tail of 38, padded to 40 by repeating its last row. With
    a labels mask the padded rows leave the loss, so the run equals the
    single process on the unpadded batches; without one they count as
    duplicated examples, as in the JAX wrapper."""
    x, y = _ff_data(1, 102)
    lm = None
    if masked:
        lm = np.ones((102, 1), np.float32)
        lm[5] = 0.0
    ranks, jr, js, tr_, ts = run_case(tmp_path, "mln", _dense_conf(seed=4),
                                      4, (x, y, None, lm), 64, 2)
    r0 = ranks[0]
    assert int(r0["last_batch_size"]) == 38
    assert np.isfinite(r0["scores"]).all()
    assert max_err(r0, jr, "param/") <= 2e-5
    np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
    single = max_err(r0, tr_, "param/")
    if masked:
        assert single <= 2e-5
        np.testing.assert_allclose(r0["scores"], ts, rtol=1e-5)
    else:
        assert single > 2e-5  # the duplicated rows moved the params


def test_tbptt_char_rnn_matches_jax(tmp_path):
    """JAX test_tbptt_dp_matches_single_device at 2 ranks: 16 sequences of
    32 steps in windows of 8, one row's labels masked after step 20; each
    window one reduced step with that window's global active count."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 32, 10)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (16, 32))]
    lm = np.ones((16, 32), np.float32)
    lm[0, 20:] = 0.0
    ranks, jr, js, tr_, ts = run_case(tmp_path, "mln", _tbptt_conf(), 2,
                                      (x, y, None, lm), 16, 2)
    r0 = ranks[0]
    assert len(r0["scores"]) == len(js) == len(ts) == 8  # 4 windows x 2
    np.testing.assert_allclose(r0["scores"], js, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=2e-4, atol=2e-5)
    assert max_err(r0, jr, "param/") <= 3e-5
    assert max_err(r0, tr_, "param/") <= 3e-5
    assert int(r0["iteration"]) == 8 and int(r0["last_batch_size"]) == 16


def test_masked_graph_tbptt_matches_jax(tmp_path):
    """A masked graph through the wrapper: a GravesLSTM graph at 2 ranks,
    16 sequences of 32 steps in windows of 8, row 0 live for 20 steps
    (features and labels masks; wholly masked in the last window), 2
    epochs; against the JAX wrapper and the port's single process at
    test_tbptt_char_rnn_matches_jax's tolerances."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((16, 32, 10)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (16, 32))]
    m = np.ones((16, 32), np.float32)
    m[0, 20:] = 0.0
    ranks, jr, js, tr_, ts = run_case(tmp_path, "cg", _masked_graph_conf(),
                                      2, (x, y, m, m.copy()), 16, 2)
    r0 = ranks[0]
    assert len(r0["scores"]) == len(js) == len(ts) == 8  # 4 windows x 2
    np.testing.assert_allclose(r0["scores"], js, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=2e-4, atol=2e-5)
    assert max_err(r0, jr, "param/") <= 3e-5
    assert max_err(r0, tr_, "param/") <= 3e-5
    assert int(r0["iteration"]) == 8 and int(r0["last_batch_size"]) == 16


def test_graph_with_merge_vertex_matches_jax(tmp_path):
    """JAX test_parallel_wrapper_with_computation_graph at 2 ranks: a
    single-input graph with a MergeVertex, shuffled each epoch from the
    iterator's seed (every rank shuffles alike)."""
    ranks, jr, js, tr_, ts = run_case(
        tmp_path, "cg", _merge_graph_conf(), 2,
        (*_ff_data(3, 128), None, None), 64, 3, shuffle=True)
    r0 = ranks[0]
    assert max_err(r0, jr, "param/") <= 2e-5
    assert max_err(r0, tr_, "param/") <= 2e-5
    np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
    assert r0["scores"][-1] < r0["scores"][0]


def test_batchnorm_graph_takes_global_batch_statistics(tmp_path):
    """The small ResNet-shaped graph (five BatchNorms) at 2 ranks, 2 steps
    of 4 images: params, running stats and slots as the JAX wrapper's at
    data=2 and the single process's. Each rank's own statistics (2 images)
    would miss those bounds: a run with them does."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    conf = small_resnet_json()
    ranks, jr, js, tr_, ts = run_case(tmp_path, "cg", conf, 2,
                                      (x, y, None, None), 4, 1)
    per_rank = spawn(tmp_path, 2, kind="cg", conf=conf,
                     weights=str(tmp_path / "weights.npz"),
                     data=str(tmp_path / "data.npz"), batch=4, epochs=1,
                     per_rank_bn=True)()
    r0 = ranks[0]
    np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=1e-5)
    for ref in (jr, tr_):
        assert max_err(r0, ref, "param/") <= 1e-5
        assert max_err(r0, ref, "state/", rel=True) <= 1e-4
    # the stem BN's beta moves values that two train-mode BNs downstream
    # centre again: its float32 gradient (1e-8) is cancellation noise, whose
    # bits depend on the order of the sums (test_torch_graph_training.py's
    # NOISE_ONLY)
    slots = {k: v for k, v in r0.items() if k != "slot/stem_bn/v/beta"}
    assert max_err(slots, {k: v for k, v in tr_.items()
                           if k != "slot/stem_bn/v/beta"},
                   "slot/", rel=True) <= 1e-4
    assert max_err(per_rank[0], jr, "state/", rel=True) > 1e-4
    assert max_err(per_rank[0], jr, "param/") > 1e-5


def test_yolo_network_takes_the_global_batch_mean(tmp_path):
    """Yolo2Output through the wrapper at 2 ranks, 3 steps of 8 images:
    each rank's score is its share of the global mean over the images, so
    the summed scores and gradients are the single process's and the JAX
    wrapper's (a rank's own mean would double both)."""
    ranks, jr, js, tr_, ts = run_case(tmp_path, "mln", _yolo_conf(), 2,
                                      (*_yolo_data(7, 24), None, None), 8,
                                      1)
    r0 = ranks[0]
    assert len(r0["scores"]) == len(js) == len(ts) == 3
    np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=1e-5)
    for ref in (jr, tr_):
        assert max_err(r0, ref, "param/") <= 1e-5
        assert max_err(r0, ref, "state/", rel=True) <= 1e-4
    assert max_err(r0, tr_, "slot/", rel=True) <= 1e-4


def test_center_loss_graph_takes_global_centers(tmp_path):
    """CenterLossOutput in a graph through the wrapper at 2 ranks, 3 epochs
    of one batch of 32 rows: the center term is each rank's share of the
    global mean and the centers move by the global batch's per-class sums
    and counts, so every rank ends with the single process's and the JAX
    wrapper's centers, scores and params."""
    ranks, jr, js, tr_, ts = run_case(tmp_path, "cg",
                                      _center_loss_graph_conf(), 2,
                                      (*_ff_data(9, 32), None, None), 32, 3)
    r0 = ranks[0]
    np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=1e-5)
    for ref in (jr, tr_):
        assert max_err(r0, ref, "param/") <= 2e-5
        assert max_err(r0, ref, "state/", rel=True) <= 1e-4
    assert max_err(r0, tr_, "slot/", rel=True) <= 1e-4
    assert np.abs(r0["state/out/centers"]).min(axis=1).max() > 0


def test_vgg16_step_with_replayed_dropout_keys(tmp_path):
    """JAX test_vgg16_data_parallel_step made exact: zoo VGG16 at 32 x 32
    x 3, 10 classes, 2 steps of 4 images at 2 ranks. The JAX network's
    keys are replayed into the port's single process, which records the
    masks it draws; the ranks replay that record, each keeping its rows of
    every global mask."""
    small = dict(num_classes=10, input_shape=(32, 32, 3))
    conf = tzoo.VGG16(**small).conf().to_json()
    assert conf == jzoo.VGG16(**small).conf().to_json()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    jnet = jax_net("mln", conf)
    tnet = port_net("mln", conf, jnet)
    tape = Tape.record(JaxKeys.for_net(tnet.conf.defaults.seed))
    tnet.draws = tape
    ts = port_fit(tnet, (x, y), 4, 2)
    assert [w[0] for w, _ in tape.tape] == ["bernoulli"] * 4
    tape.save(str(tmp_path / "tape.npz"))
    wait = spawn(tmp_path, 2, kind="mln", conf=conf,
                 weights=save_weights(tmp_path, jnet),
                 data=save_data(tmp_path, "data", x, y), batch=4, epochs=2,
                 tape=str(tmp_path / "tape.npz"))
    js = jax_fit(jnet, 2, (x, y), 4, 2)
    ranks = wait()
    same_on_every_rank(ranks)
    r0, jr, tr_ = ranks[0], jax_results(jnet), results(tnet, ts)
    np.testing.assert_allclose(r0["scores"], js, rtol=1e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=1e-5)
    assert max_err(r0, jr, "param/") <= 1e-5
    assert max_err(r0, tr_, "param/") <= 1e-5
    assert max_err(r0, tr_, "slot/", rel=True) <= 1e-4


def test_refusals(tmp_path):
    """The dcn axis runs (tests/test_torch_dcn.py): without a process
    group its grid asks for one, and an empty axis raises; the JAX
    wrapper's refusals of axis compositions stand: pipe x seq, pipe x
    model, fsdp x seq, tBPTT x seq, and an LSTM under seq with JAX's
    sp_safe message (here, before any group exists; the seq, pipe and
    expert axes run, tests/test_torch_sequence_pipeline.py and
    tests/test_torch_sharded_transformer.py); in a group of 2, a data axis
    of 3 and a dcn x data grid of 4 ranks raise, and ranks that iterate
    different data raise on every rank."""
    with pytest.raises(RuntimeError, match="no process group"):
        build_mesh(MeshSpec(dcn=2))
    with pytest.raises(ValueError, match="at least one rank"):
        build_mesh(MeshSpec(dcn=0))
    def net(conf):
        return MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf)).init(device="cpu")

    dense = net(_dense_conf())
    lstm = net(NeuralNetConfiguration(seed=1).list([
        LSTM(n_out=8), RnnOutput(n_out=3, loss="mcxent")]).set_input_type(
            it.recurrent(4, 8)).to_json())
    tbptt = net(NeuralNetConfiguration(
        seed=1, backprop_type="tbptt", tbptt_fwd_length=4).list([
            LSTM(n_out=8), RnnOutput(n_out=3, loss="mcxent")]
    ).set_input_type(it.recurrent(4, 8)).to_json())
    for net, spec, match in (
            (dense, MeshSpec(data=2, pipe=2, seq=2), "pipe x seq"),
            (dense, MeshSpec(data=2, pipe=2, model=2), "pipe x model"),
            (dense, MeshSpec(fsdp=2, seq=2), "fsdp composes"),
            (tbptt, MeshSpec(data=2, seq=2), "truncated BPTT"),
            (lstm, MeshSpec(data=2, seq=2), "LSTM reduces/restructures "
             r"the time axis .*sp_safe=False")):
        with pytest.raises(ValueError, match=match):
            ParallelWrapper(net, mesh_spec=spec)
    with pytest.raises(ValueError, match="rendezvous"):
        init_process_group("tcp://10.0.0.1:1234", 0, 1, device="cpu")
    seen = spawn(tmp_path, 2, kind="mln", conf=_dense_conf(),
                 data=save_data(tmp_path, "data", *_ff_data(0, 16)),
                 batch=16, epochs=1, refusals=True)()
    for rank in seen:
        assert "needs 3 ranks" in rank["world"]
        assert "needs 4 ranks" in rank["axis"]
        assert "'dcn': 2" in rank["axis"]
        assert "different batches" in rank["batch"]


def test_pad_batch_repeats_the_last_row_and_masks_it():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    lm = np.ones((3, 1), np.float32)
    for arrays in ((x, x, None, lm),
                   tuple(None if a is None else torch.from_numpy(a)
                         for a in (x, x, None, lm))):
        ds = pad_batch(DataSet(*arrays), 2)
        feats = np.asarray(ds.features)
        assert feats.shape == (5, 4)
        np.testing.assert_array_equal(feats[3:], [x[2], x[2]])
        np.testing.assert_array_equal(np.asarray(ds.labels_mask)[:, 0],
                                      [1, 1, 1, 0, 0])
        assert ds.features_mask is None
    assert lm.min() == 1.0  # the caller's mask is not written to


def test_mesh_spec_as_jax():
    spec = MeshSpec(data=4, model=2)
    jspec = JMeshSpec(data=4, model=2)
    assert spec.total() == jspec.total() == 8
    assert spec.axis_sizes() == jspec.axis_sizes()
    assert MeshSpec.data_parallel(3) == MeshSpec(data=3)
