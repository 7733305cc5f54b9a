"""The port's ParallelWrapper on the seq and pipe axes against the JAX
package's ParallelWrapper on the same mesh (its first four virtual
devices) and against the port's single process, on the same numpy-seeded
inputs and the JAX network's weights: the counterparts of
tests/test_parallel.py's dp x sp, tp x sp, dp x pp and masked-loss tests.

The port's four ranks run as tests/torch_dp_worker.py processes (gloo, a
file:// rendezvous), every case of this file one after another in one
process group (`Cases`, started once per module). Tolerances are
tests/test_parallel.py's: scores rtol 3e-4 / atol 3e-5; params 3e-5 of
the single process and of JAX (the masked Sgd nets' params 3e-6, the
JAX test's own).
"""
import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    EmbeddingSequence,
    GlobalPooling,
    Output,
    PositionEmbedding,
    RnnOutput,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper
from test_torch_parallel import (
    Scores,
    jax_net,
    jax_results,
    max_err,
    port_fit,
    port_net,
)
from test_torch_tensor_parallel import Cases, save, save_weights
from torch_dp_worker import results

RTOL, ATOL, PTOL = 3e-4, 3e-5, 3e-5


# ------------------------------------------------------------ nets
def _lm_conf(n_heads):
    return tzoo.TransformerLM(num_classes=53, max_length=16, d_model=32,
                              n_heads=n_heads, n_layers=2).conf().to_json()


def _lm_data(seed=0, n=16, t=16, v=53):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (n, t)).astype(np.float32)
    return ids, np.eye(v, dtype=np.float32)[rng.integers(0, v, (n, t))]


def _sgd_lm_conf(v=53, t=16):
    """tests/test_parallel.py's Sgd LM of the masked-loss tests."""
    return NeuralNetConfiguration(
        seed=9, updater=updaters.Sgd(learning_rate=0.1),
        weight_init="xavier").list([
            EmbeddingSequence(n_in=v, n_out=32),
            PositionEmbedding(max_len=t),
            TransformerBlock(n_heads=4, causal=True),
            RnnOutput(n_out=v, loss="mcxent", activation="softmax"),
        ]).set_input_type(it.recurrent(v, t)).to_json()


def _masked_data(seed=3, v=53, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (4, t)).astype(np.float32)
    tgt = np.eye(v, dtype=np.float32)[rng.integers(0, v, (4, t))]
    lm = np.ones((4, t), np.float32)
    lm[:, 11:] = 0.0   # a dead tail: most of the second seq shard
    lm[0, :3] = 0.0    # a ragged head on one example
    lm[2] = 0.0        # a dead example in the second data shard
    return ids, tgt, lm


def _conv_conf():
    """conv -> flatten -> dense -> output: the pipe stages cut between the
    conv and the dense layer, the boundary a [b, 6, 6, 4] activation
    flattened by the second stage's preprocessor."""
    return NeuralNetConfiguration(
        seed=5, updater=updaters.Adam(learning_rate=5e-3)).list([
            Conv2D(n_out=4, kernel_size=(3, 3), activation="relu"),
            Dense(n_out=16, activation="tanh"),
            Output(n_out=3, loss="mcxent"),
        ]).set_input_type(it.convolutional(8, 8, 1)).to_json()


def _conv_data(seed=4, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 1)).astype(np.float32)
    ids = rng.integers(0, 3, n)
    x[:, 0, 0, 0] += 2.0 * ids
    return x, np.eye(3, dtype=np.float32)[ids]


# name -> (conf, data, batch, epochs, mesh, microbatches, params tol)
NETS = {
    "lm_dp_sp": (lambda: _lm_conf(2), _lm_data, 8, 1,
                 {"data": 2, "seq": 2}, None, PTOL),
    "lm_tp_sp": (lambda: _lm_conf(4), _lm_data, 8, 1,
                 {"model": 2, "seq": 2}, None, PTOL),
    "lm_dp_pp_m4": (lambda: _lm_conf(4), _lm_data, 8, 1,
                    {"data": 2, "pipe": 2}, 4, PTOL),
    "lm_dp_pp": (lambda: _lm_conf(2), _lm_data, 8, 1,
                 {"data": 2, "pipe": 2}, None, PTOL),
    "masked_sp": (_sgd_lm_conf, _masked_data, 4, 1,
                  {"data": 2, "seq": 2}, None, 3e-6),
    "masked_pp": (_sgd_lm_conf, _masked_data, 4, 1,
                  {"data": 2, "pipe": 2}, None, 3e-6),
    "conv_pp": (_conv_conf, _conv_data, 8, 1,
                {"data": 2, "pipe": 2}, 2, PTOL),
}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    base = tmp_path_factory.mktemp("sp_pp")
    specs, nets = {}, {}
    for name, (conf, data, batch, epochs, mesh, micro, _) in NETS.items():
        cj = conf()
        jnet = jax_net("mln", cj)
        arrays = data()
        lm = arrays[2] if len(arrays) > 2 else None
        specs[name] = dict(kind="mln", conf=cj,
                           weights=save_weights(base, name, jnet),
                           data=save(base, name, x=arrays[0], y=arrays[1],
                                     lm=lm),
                           batch=batch, epochs=epochs, mesh=mesh,
                           microbatches=micro)
        nets[name] = (cj, jnet, arrays, batch, epochs, mesh, micro)
    group = Cases(base, 4, specs)
    yield {"nets": nets, "group": group}
    group.stop()


def jax_fit(jnet, mesh, data, batch, epochs, microbatches):
    log = Scores()
    jnet.set_listeners(log)
    n = int(np.prod(list(mesh.values())))
    JWrapper(jnet, mesh=jbuild_mesh(JMeshSpec(**mesh),
                                    devices=jax.devices()[:n]),
             microbatches=microbatches).fit(
        JListIterator(jds.DataSet(*data), batch=batch), epochs=epochs)
    return log.scores


def check(cases, name):
    cj, jnet, data, batch, epochs, mesh, micro = cases["nets"][name]
    ptol = NETS[name][-1]
    tnet = port_net("mln", cj, jnet)
    arrays = ((data[0], data[1], None, data[2]) if len(data) > 2
              else tuple(data))
    ts = port_fit(tnet, arrays, batch, epochs)
    js = jax_fit(jnet, mesh, arrays, batch, epochs, micro)
    r0 = cases["group"].result(name)[0]
    assert len(r0["scores"]) == len(js) == len(ts) > 0
    np.testing.assert_allclose(r0["scores"], js, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r0["scores"], ts, rtol=RTOL, atol=ATOL)
    assert max_err(r0, results(tnet, ts), "param/") <= ptol
    assert max_err(r0, jax_results(jnet), "param/") <= ptol
    return r0


# ------------------------------------------------------------ cases
def test_zoo_lm_dp_sp_matches_jax(cases):
    """JAX test_zoo_transformer_lm_dp_sp_matches_single_device: the zoo
    TransformerLM (head dim 16: the ring's hops on the flash kernels'
    plain versions) at data=2 x seq=2, 2 batches of 8 x 16."""
    r0 = check(cases, "lm_dp_sp")
    assert int(r0["coll/seq"]) > 0


def test_zoo_lm_tp_sp_matches_jax(cases):
    """JAX test_zoo_transformer_lm_tp_sp_composes: model=2 x seq=2, each
    rank's ring over its 2 of the 4 heads (head dim 8: the online hop)."""
    r0 = check(cases, "lm_tp_sp")
    assert int(r0["coll/seq"]) > 0 and int(r0["coll/model"]) > 0


def test_zoo_lm_dp_pp_microbatches_matches_jax(cases):
    """JAX test_zoo_transformer_lm_dp_pp_matches_single_device at
    data=2 x pipe=2 with microbatches=4 (a local batch of 4)."""
    r0 = check(cases, "lm_dp_pp_m4")
    assert int(r0["coll/pipe"]) > 0


def test_zoo_lm_dp_pp_default_microbatches_matches_jax(cases):
    """The same at the default depth (the largest divisor of the local
    batch up to pipe: 2)."""
    check(cases, "lm_dp_pp")


def test_sp_ragged_label_masks_match_jax(cases):
    """JAX test_sp_masked_loss_matches_single_device: ragged label masks
    across the seq shards (a dead tail, a ragged head, a dead example):
    each rank's loss is its share of the global masked mean before the
    gradient."""
    check(cases, "masked_sp")


def test_pp_label_masks_match_jax(cases):
    """JAX test_pp_masked_loss_matches_single_device at data=2 x pipe=2."""
    check(cases, "masked_pp")


def test_pp_conv_to_dense_stage_boundary_matches_jax(cases):
    """JAX test_mlp_dp_pp_heterogeneous_stages with a conv -> dense
    boundary: the stages hand a [b, 6, 6, 4] activation across (its shape
    sent once) and the second stage's preprocessor flattens it."""
    check(cases, "conv_pp")


# ------------------------------------------------------------ refusals
def _net(conf):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf)).init(device="cpu")


def test_pp_refusals_name_the_jax_reasons():
    """The pipe axis refuses, before any group exists, what the JAX
    wrapper refuses: running state, a graph, no loss layer, fewer
    pipelineable layers than stages."""
    bn = _net(NeuralNetConfiguration(seed=1).list([
        Dense(n_out=16, activation="relu"), BatchNorm(),
        Output(n_out=3, loss="mcxent")]).set_input_type(
            it.feed_forward(8)).to_json())
    with pytest.raises(ValueError, match="BatchNorm"):
        ParallelWrapper(bn, mesh_spec=MeshSpec(data=2, pipe=2))
    cg = ComputationGraph(ComputationGraphConfiguration(
        defaults=NeuralNetConfiguration(seed=1)).add_inputs("in")
        .add_layer("d", Dense(n_out=4), "in")
        .add_layer("out", Output(n_out=3, loss="mcxent"), "d")
        .set_outputs("out").set_input_types(it.feed_forward(8))).init(
            device="cpu")
    with pytest.raises(ValueError, match="sequential layer stack"):
        ParallelWrapper(cg, mesh_spec=MeshSpec(pipe=2))
    no_loss = _net(NeuralNetConfiguration(seed=1).list([
        Dense(n_out=4), Dense(n_out=3)]).set_input_type(
            it.feed_forward(8)).to_json())
    with pytest.raises(ValueError, match="loss-bearing"):
        ParallelWrapper(no_loss, mesh_spec=MeshSpec(pipe=2))
    short = _net(NeuralNetConfiguration(seed=1).list([
        Dense(n_out=4), Output(n_out=3, loss="mcxent")]).set_input_type(
            it.feed_forward(8)).to_json())
    with pytest.raises(ValueError, match="cannot fill pipe=2"):
        ParallelWrapper(short, mesh_spec=MeshSpec(pipe=2))


def test_sp_refuses_time_reducing_layers_and_preprocessors():
    """JAX test_sp_refuses_time_reducing_layers: a pooling layer under the
    seq axis, and an MLN whose input needs a preprocessor."""
    pool = _net(NeuralNetConfiguration(seed=1).list([
        Dense(n_out=8), GlobalPooling(pooling_type="avg"),
        Output(n_out=3, loss="mcxent")]).set_input_type(
            it.recurrent(4, 8)).to_json())
    with pytest.raises(ValueError, match="GlobalPooling .*sp_safe=False"):
        ParallelWrapper(pool, mesh_spec=MeshSpec(seq=2))
    conv = _net(_conv_conf())
    with pytest.raises(ValueError, match="Conv2D|input preprocessor"):
        ParallelWrapper(conv, mesh_spec=MeshSpec(seq=2))


def test_microbatches_must_divide_the_local_batch():
    """JAX's message for a local batch that microbatches do not divide."""
    pw = ParallelWrapper.__new__(ParallelWrapper)
    pw.microbatches = 3
    pw.mesh = type("G", (), {"pipe": type("A", (), {"size": 2})()})()
    with pytest.raises(ValueError, match="must divide into microbatches=3"):
        pw._microbatches(4)
    pw.microbatches = None
    assert pw._microbatches(4) == 2 and pw._microbatches(3) == 1
