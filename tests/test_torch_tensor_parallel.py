"""The port's model axis (tensor parallelism from the layers' partition
specs) against the JAX package's ParallelWrapper at MeshSpec(data=2,
model=2) on four virtual devices and against the port's own single
process, on the same numpy-seeded inputs and the JAX network's weights:
the counterparts of tests/test_parallel.py's dp x tp tests.

The port's four ranks run as tests/torch_dp_worker.py processes (gloo, a
file:// rendezvous), all of this file's cases one after another in one
process group (`Cases`, started once per module), while each test runs
the JAX wrapper and the port's single process here. The JAX tests use
data=2 x model=4 over eight devices; the port runs data=2 x model=2, the
JAX wrapper beside it the same mesh.

Tolerances are the JAX tests' own: the tp MLP scores rtol 2e-4 / atol
2e-5 and params 2e-5 (test_tp_matches_single_device), the TransformerLM
and the imported Keras net rtol 3e-4 / atol 3e-5, the graph rtol 2e-4
and params 2e-5, VGG16 rtol 5e-4 / atol 5e-5, the LSTM rtol 2e-4 / atol
2e-5 and params 3e-5, tBPTT rtol 2e-4 / atol 2e-5.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.modelimport import (
    import_keras_sequential_model_and_weights as jimport_sequential,
)
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.modelimport import (
    import_keras_sequential_model_and_weights as timport_sequential,
)
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.layers import LSTM, Dense, Output, RnnOutput
from test_torch_parallel import (
    WORKER,
    Scores,
    jax_net,
    jax_results,
    max_err,
    port_fit,
    port_net,
    same_on_every_rank,
)
from torch_dp_worker import Tape, results
from torch_keys import JaxKeys

TFSCOPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "keras_ref", "tfscope", "model.h5")
DP_TP = {"data": 2, "model": 2}


# ------------------------------------------------------------ harness
class Cases:
    """A process group of `world` worker ranks running `cases` ({name:
    spec}) one after another; `result(name)` waits for the group once
    and gives each rank's results of that case."""

    def __init__(self, base, world, cases):
        self.base, self.world, self.names = base, world, list(cases)
        init = f"file://{base}/rdv"
        self.procs = []
        for r in range(world):
            # one thread per rank: four ranks beside the test's own
            # process stay within a test worker's share of the host
            spec = {"rank": r, "world": world, "init": init, "threads": 1,
                    "cases": [dict(c, out=str(base / f"{n}_rank{r}.npz"))
                              for n, c in cases.items()]}
            path = base / f"spec{r}.json"
            path.write_text(json.dumps(spec))
            self.procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        self.logs = None

    def wait(self, timeout=420):
        if self.logs is None:
            try:
                self.logs = [p.communicate(timeout=timeout)[0].decode()
                             for p in self.procs]
            finally:
                self.stop()
        failed = [f"rank {r}:\n{log[-3000:]}" for r, (p, log) in
                  enumerate(zip(self.procs, self.logs)) if p.returncode]
        assert not failed, "\n".join(failed)

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def result(self, name):
        self.wait()
        ranks = [dict(np.load(self.base / f"{name}_rank{r}.npz"))
                 for r in range(self.world)]
        same_on_every_rank(ranks)
        return ranks


def save(base, name, **arrays):
    path = str(base / f"{name}.npz")
    np.savez(path, **{k: v for k, v in arrays.items() if v is not None})
    return path


def save_weights(base, name, jnet):
    out = {}
    for kind, tree in (("param", jnet.params), ("state", jnet.state)):
        for path, leaf in flat_items(jax.tree_util.tree_map(np.asarray,
                                                            tree)):
            out[f"{kind}/{path}"] = leaf
    return save(base, f"{name}_weights", **out)


def jax_fit(jnet, mesh, data, batch, epochs=1):
    """The JAX ParallelWrapper on `mesh` (axis sizes) over the first
    devices; per-step scores."""
    log = Scores()
    jnet.set_listeners(log)
    n = int(np.prod(list(mesh.values())))
    JWrapper(jnet, mesh=jbuild_mesh(JMeshSpec(**mesh),
                                    devices=jax.devices()[:n])).fit(
        JListIterator(jds.DataSet(*data), batch=batch), epochs=epochs)
    return log.scores


def local(rank, key):
    return int(rank[f"local/param/{key}"])


# ------------------------------------------------------------ nets
def _mlp_conf():
    return NeuralNetConfiguration(
        seed=11, updater=updaters.Adam(learning_rate=5e-3)).list([
            Dense(n_out=32, activation="relu"),
            Output(n_out=3, loss="mcxent"),
        ]).set_input_type(it.feed_forward(8)).to_json()


def _mlp_reg_conf():
    """The tp MLP with l1 and l2 on its kernels and biases and its
    gradients clipped by each layer's global L2 norm: the penalty and the
    norms span every rank's slice."""
    return NeuralNetConfiguration(
        seed=12, updater=updaters.Adam(learning_rate=5e-3), l1=1e-4,
        l2=1e-3, l2_bias=1e-3, gradient_normalization="ClipL2PerLayer",
        gradient_normalization_threshold=0.05).list([
            Dense(n_out=32, activation="relu"),
            Output(n_out=3, loss="mcxent"),
        ]).set_input_type(it.feed_forward(8)).to_json()


def _ff_data(seed, n, f=8, c=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    ids = rng.integers(0, c, n)
    x[:, 0] += 2.0 * ids
    return x, np.eye(c, dtype=np.float32)[ids]


def _lm_conf():
    return tzoo.TransformerLM(num_classes=53, max_length=16, d_model=32,
                              n_heads=4, n_layers=2).conf().to_json()


def _lm_data(seed=0, n=12, t=16, v=53):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (n, t)).astype(np.float32)
    return ids, np.eye(v, dtype=np.float32)[rng.integers(0, v, (n, t))]


def _graph_conf():
    return ComputationGraphConfiguration(
        defaults=NeuralNetConfiguration(
            seed=7, updater=updaters.Adam(learning_rate=5e-3))) \
        .add_inputs("in") \
        .add_layer("a", Dense(n_out=16, activation="relu"), "in") \
        .add_layer("b", Dense(n_out=16, activation="tanh"), "in") \
        .add_vertex("m", MergeVertex(), "a", "b") \
        .add_layer("out", Output(n_out=3, loss="mcxent"), "m") \
        .set_outputs("out").set_input_types(it.feed_forward(8)).to_json()


def _lstm_conf(v=12, t=10, n=32):
    return NeuralNetConfiguration(
        seed=5, updater=updaters.Adam(learning_rate=5e-3)).list([
            LSTM(n_out=n, activation="tanh"),
            RnnOutput(n_out=v, loss="mcxent"),
        ]).set_input_type(it.recurrent(v, t)).to_json()


def _tbptt_conf():
    return NeuralNetConfiguration(
        seed=4, updater=updaters.Adam(learning_rate=5e-3),
        backprop_type="tbptt", tbptt_fwd_length=8).list([
            LSTM(n_out=24, activation="tanh"),
            RnnOutput(n_out=10, loss="mcxent"),
        ]).set_input_type(it.recurrent(10, 32)).to_json()


def _seq_data(seed, n, t, v):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, v)).astype(np.float32)
    return x, np.eye(v, dtype=np.float32)[rng.integers(0, v, (n, t))]


VGG = dict(num_classes=10, input_shape=(32, 32, 3), seed=7)


def _vgg_data():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]


def _tfscope_data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 70)).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]


# name -> (kind, conf, data, batch, epochs)
def _lm_drop_conf():
    """The zoo TransformerLM with dropout 0.8 on each block's FFN hidden
    layer: under the model axis each rank draws its columns of the whole
    mask."""
    conf = tzoo.TransformerLM(num_classes=53, max_length=16, d_model=32,
                              n_heads=4, n_layers=2).conf()
    for layer in conf.layers:
        if type(layer).__name__ == "TransformerBlock":
            layer.dropout = 0.8
    return conf.to_json()


NETS = {
    "mlp": ("mln", _mlp_conf, lambda: _ff_data(0, 32), 8, 1),
    "lm_drop": ("mln", _lm_drop_conf, _lm_data, 4, 1),
    "vgg": ("mln", lambda: tzoo.VGG16(**VGG).conf().to_json(), _vgg_data,
            4, 1),
    "mlp_reg": ("mln", _mlp_reg_conf, lambda: _ff_data(5, 32), 8, 1),
    "lm": ("mln", _lm_conf, _lm_data, 4, 1),
    "graph": ("cg", _graph_conf, lambda: _ff_data(1, 16), 16, 1),
    "lstm": ("mln", _lstm_conf, lambda: _seq_data(2, 16, 10, 12), 8, 1),
    "tbptt": ("mln", _tbptt_conf, lambda: _seq_data(4, 8, 32, 10), 8, 1),
}
TAPED = ("vgg", "lm_drop")


def start_cases(base, mesh, names):
    """The JAX networks (unfitted) and data of the named cases, and the
    port's four ranks started on all of them at `mesh`. The cases in
    TAPED draw the JAX keys' dropout masks: the port's single process
    records them and every rank replays them (its part of each); "tfscope"
    is the Keras file, imported by each package."""
    specs, nets = {}, {}
    for name in names:
        if name == "tfscope":
            x, y = _tfscope_data()
            specs[name] = dict(keras=TFSCOPE, batch=8, epochs=3,
                               data=save(base, name, x=x, y=y))
            continue
        kind, conf, data, batch, epochs = NETS[name]
        cj = conf()
        jnet = jax_net(kind, cj)
        arrays = data()
        specs[name] = dict(kind=kind, conf=cj,
                           weights=save_weights(base, name, jnet),
                           data=save(base, name, x=arrays[0], y=arrays[1]),
                           batch=batch, epochs=epochs)
        single = None
        if name in TAPED:
            tnet = port_net(kind, cj, jnet)
            tape = Tape.record(JaxKeys.for_net(tnet.conf.defaults.seed))
            tnet.draws = tape
            single = (tnet, port_fit(tnet, arrays, batch, epochs))
            tape.save(str(base / f"{name}_tape.npz"))
            specs[name]["tape"] = str(base / f"{name}_tape.npz")
        nets[name] = (kind, cj, jnet, arrays, batch, epochs, single)
    group = Cases(base, 4, {n: dict(c, mesh=mesh) for n, c in specs.items()})
    return {"nets": nets, "group": group, "mesh": mesh}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    c = start_cases(tmp_path_factory.mktemp("tp"), DP_TP,
                    ["mlp", "mlp_reg", "lm", "lm_drop", "graph", "lstm",
                     "tbptt", "tfscope", "vgg"])
    yield c
    c["group"].stop()


def run(cases, name):
    """(rank 0's results, the JAX wrapper's results and scores, the
    port's single-process results and scores) of case `name`."""
    kind, conf, jnet, data, batch, epochs, single = cases["nets"][name]
    if single is None:
        tnet = port_net(kind, conf, jnet)
        ts = port_fit(tnet, data, batch, epochs)
    else:
        tnet, ts = single
    js = jax_fit(jnet, cases["mesh"], data, batch, epochs)
    ranks = cases["group"].result(name)
    return ranks[0], jax_results(jnet), js, results(tnet, ts), ts


def split(r0, key):
    """How many ranks' slices make the whole param `key`."""
    return r0[f"param/{key}"].size // local(r0, key)


def fsdp_on(cases):
    return cases["mesh"].get("fsdp", 1) > 1


# ------------------------------------------------------------ checks
# (shared with tests/test_torch_fsdp.py, which runs them at fsdp x model)
def check_mlp(cases):
    r0, jr, js, tr_, ts = run(cases, "mlp")
    assert len(r0["scores"]) == len(js) == 4
    np.testing.assert_allclose(r0["scores"], js, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=2e-4, atol=2e-5)
    assert max_err(r0, jr, "param/") <= 2e-5
    assert max_err(r0, tr_, "param/") <= 2e-5
    n = 4 if fsdp_on(cases) else 2
    assert split(r0, "layer_0/W") == n
    assert r0["slot/0/m/W"].size // int(r0["local/slot/layer_0/m/W"]) == n
    assert split(r0, "layer_0/b") == 2
    assert int(r0["coll/model"]) > 0


def check_mlp_reg(cases):
    r0, jr, js, tr_, ts = run(cases, "mlp_reg")
    np.testing.assert_allclose(r0["scores"], js, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=2e-4, atol=2e-5)
    assert max_err(r0, jr, "param/") <= 2e-5
    assert max_err(r0, tr_, "param/") <= 2e-5
    assert int(r0["coll/shard"]) > 0  # the penalty's and norms' sums


def check_lm(cases):
    r0, jr, js, tr_, ts = run(cases, "lm")
    np.testing.assert_allclose(r0["scores"], js, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=3e-4, atol=3e-5)
    assert max_err(r0, tr_, "param/") <= 3e-5
    assert max_err(r0, jr, "param/") <= 3e-5
    n = 4 if fsdp_on(cases) else 2
    for path in ("layer_2/attn/Wqkv", "layer_2/attn/Wo", "layer_2/W1",
                 "layer_2/W2"):
        assert split(r0, path) == n, path
    assert split(r0, "layer_0/W") == 2  # a vocab of 53: no fsdp split
    assert split(r0, "layer_2/attn/bqkv") == 2
    assert split(r0, "layer_2/attn/bo") == 1  # added after the sum


def check_lm_drop(cases):
    r0, jr, js, tr_, ts = run(cases, "lm_drop")
    np.testing.assert_allclose(r0["scores"], js, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=3e-4, atol=3e-5)
    assert max_err(r0, tr_, "param/") <= 3e-5
    assert max_err(r0, jr, "param/") <= 3e-5


def check_graph(cases):
    r0, jr, js, tr_, ts = run(cases, "graph")
    np.testing.assert_allclose(r0["scores"], js, rtol=2e-4)
    np.testing.assert_allclose(r0["scores"], ts, rtol=2e-4)
    assert max_err(r0, jr, "param/a/W") <= 2e-5
    assert max_err(r0, tr_, "param/") <= 2e-5
    n = 4 if fsdp_on(cases) else 2
    assert split(r0, "a/W") == split(r0, "b/W") == n


def check_lstm(cases):
    r0, jr, js, tr_, ts = run(cases, "lstm")
    np.testing.assert_allclose(r0["scores"], js, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=2e-4, atol=2e-5)
    assert max_err(r0, jr, "param/layer_0/W") <= 3e-5
    assert max_err(r0, tr_, "param/") <= 3e-5
    n = 4 if fsdp_on(cases) else 2
    assert split(r0, "layer_0/W") == split(r0, "layer_0/R") == n
    assert r0["slot/0/m/W"].size // int(r0["local/slot/layer_0/m/W"]) == n


def check_tfscope(cases):
    x, y = _tfscope_data()
    a = timport_sequential(TFSCOPE, device="cpu")
    ts = port_fit(a, (x, y), 8, 3)
    jnet = jimport_sequential(TFSCOPE)
    js = jax_fit(jnet, cases["mesh"], (x, y), 8, 3)
    r0 = cases["group"].result("tfscope")[0]
    np.testing.assert_allclose(r0["scores"], js, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=3e-4, atol=3e-5)
    assert max_err(r0, results(a, ts), "param/") <= 3e-5
    assert max_err(r0, jax_results(jnet), "param/") <= 3e-5
    assert [k for k in r0 if k.startswith("local/param/")
            and split(r0, k[len("local/param/"):]) > 1]


def check_vgg(cases):
    r0, jr, js, tr_, ts = run(cases, "vgg")
    np.testing.assert_allclose(r0["scores"], js, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=5e-4, atol=5e-5)
    assert max_err(r0, tr_, "param/") <= 5e-5
    tnet = cases["nets"]["vgg"][6][0]
    n_conv = 0
    for i, layer in enumerate(tnet.layers):
        if type(layer).__name__ == "Conv2D":
            # cout over 'model'; under fsdp cin too, but for the 3 input
            # channels of the first
            want = (2, 4) if fsdp_on(cases) and i else (2,)
            assert split(r0, f"layer_{i}/W") in want, i
            n_conv += 1
    assert n_conv == 13


# ------------------------------------------------------------ cases
def test_tp_mlp_matches_jax_and_single_process(cases):
    """JAX test_tp_matches_single_device: Dense(32) + Output(3), Adam, 4
    batches of 8; W column-split 2 ways (b with it), Adam's slots with
    it."""
    check_mlp(cases)


def test_penalty_and_gradient_norms_span_the_slices(cases):
    """l1 and l2 in the score and the global L2 norm of ClipL2PerLayer
    under data x model: every slice counts once (a replicated bias once,
    not once per rank), so scores and params are JAX's and the single
    process's at the tp MLP's tolerances."""
    check_mlp_reg(cases)


def test_zoo_transformer_lm_dp_tp_matches_jax(cases):
    """JAX test_zoo_transformer_lm_dp_tp_matches_single_device: the zoo
    TransformerLM with its heads split 2 ways (Wqkv, bqkv by heads, Wo
    by rows) and the FFN Megatron-split, 3 batches of 4."""
    check_lm(cases)


def test_split_ffn_dropout_takes_its_columns_of_the_mask(cases):
    """The TransformerLM with FFN dropout under data x model, the JAX
    keys' masks replayed: each rank's hidden columns take their part of
    the whole mask, so the run is the single process's and JAX's."""
    check_lm_drop(cases)


def test_graph_dp_tp_matches_jax(cases):
    """JAX test_cg_dp_tp_matches_single_device: a graph of two Dense
    branches merged into an Output, each vertex split by its own spec."""
    check_graph(cases)


def test_lstm_char_rnn_tp_matches_jax(cases):
    """JAX test_lstm_char_rnn_tp_matches_single_device: the gate axis of
    W, R and b split 2 ways at rest (the Adam moments with them) and
    gathered on use, 2 batches of 8."""
    check_lstm(cases)


def test_tbptt_dp_tp_matches_jax(cases):
    """JAX test_tbptt_dp_tp_and_refusals' run: 8 sequences of 32 steps in
    tBPTT windows of 8 under data x model, the LSTM's gate split kept
    through the windows (its refusals: tests/test_torch_fsdp.py)."""
    r0, jr, js, tr_, ts = run(cases, "tbptt")
    assert len(r0["scores"]) == len(js) == len(ts) == 4
    np.testing.assert_allclose(r0["scores"], js, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r0["scores"], ts, rtol=2e-4, atol=2e-5)
    assert max_err(r0, tr_, "param/") <= 3e-5
    assert local(r0, "layer_0/W") == 10 * 48  # 96 / 2 gate columns


def test_imported_keras_net_trains_dp_tp(cases):
    """JAX test_imported_net_trains_dp_tp: the tfscope Keras model,
    imported by each package from the .h5, 3 steps under data x model
    against the JAX wrapper and the port's single process."""
    check_tfscope(cases)


def test_vgg16_dp_tp_splits_every_conv_on_cout(cases):
    """JAX test_vgg16_dp_tp_shards_conv_kernels: zoo VGG16 at 32x32, 2
    steps of 4 images under data x model; all 13 conv kernels split 2
    ways on cout at rest, the dropout masks the JAX keys'."""
    check_vgg(cases)
