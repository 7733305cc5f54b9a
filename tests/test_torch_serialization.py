"""The port's checkpoint zip (models/serialization.py) against the JAX
package's, in both directions.

A zip written by either package is restored by the other: the same
members, the same npz keys and arrays (dtypes included), the same params,
running state and updater slots bit for bit, and outputs within 1e-5 of
each other (float32 on both sides). The committed checkpoint fixtures the
port can build restore against tests/fixtures/expected_outputs.npz at 1e-5
and keep training as the JAX package's copy does (dropout and weight
noise with the JAX network's keys replayed into the port's draws).
"""
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds_mod
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models import serialization as jser
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import (
    ComputationGraph,
    MultiLayerNetwork,
    restore_computation_graph,
    restore_model,
    restore_multi_layer_network,
    write_model,
)
from deeplearning4j_tpu_torch.models import serialization as tser
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
    Output,
    Subsampling2D,
)
from torch_graphs import small_resnet_json
from torch_keys import JaxKeys

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")
EXPECTED = np.load(os.path.join(FIXDIR, "expected_outputs.npz"))
READABLE = ["cg_branch_merge", "mln_graves_lstm", "mln_vit",
            "mln_conv_bn_noise", "mln_scheduled_dropout", "mln_bidir_lstm"]
# refused until their classes were ported (ROADMAP A.4): fixture -> the
# (layer, dropout, weight noise) class names its layers name
ONCE_REFUSED = {
    "mln_conv_bn_noise": [(3, "AlphaDropout", "DropConnect")],
    "mln_scheduled_dropout": [(0, "Dropout", "DropConnect"),
                              (1, "GaussianNoise", None)]}
JCONF = {JMLN: JConf, JCG: JGConf}
TCONF = {MultiLayerNetwork: MultiLayerConfiguration,
         ComputationGraph: ComputationGraphConfiguration}


def _members(path):
    """{member: bytes or {npz key: array}} of a checkpoint zip, with
    metadata.json parsed."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            raw = z.read(name)
            if name.endswith(".npz"):
                d = np.load(io.BytesIO(raw))
                out[name] = {k: d[k] for k in d.files}
            else:
                out[name] = json.loads(raw)
    return out


def _same_members(a, b):
    ma, mb = _members(a), _members(b)
    assert sorted(ma) == sorted(mb)
    for name in ma:
        if name.endswith(".npz"):
            assert list(ma[name]) == list(mb[name]), name
            for k, v in mb[name].items():
                assert ma[name][k].dtype == v.dtype, (name, k)
                np.testing.assert_array_equal(ma[name][k], v,
                                              err_msg=f"{name}/{k}")
        else:
            assert ma[name] == mb[name], name


def _mln_conf():
    """Conv (a kernel whose layouts differ) -> BatchNorm -> pool -> dense
    -> softmax, Adam (a step count per layer, paramless ones too)."""
    return NeuralNetConfiguration(
        seed=5, updater=updaters.Adam(learning_rate=1e-2), l2=1e-4,
    ).list([
        Conv2D(kernel_size=(3, 3), n_out=4, convolution_mode="same",
               activation="relu"),
        BatchNorm(),
        Subsampling2D(kernel_size=(2, 2), stride=(2, 2)),
        Dense(n_out=6, activation="tanh"),
        Output(n_out=3, loss="mcxent"),
    ]).set_input_type(it.convolutional(6, 6, 2))


def _data(rng, x_shape, n_out):
    x = rng.normal(0, 1, x_shape).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, x_shape[0])]
    return x, y


def _trained_pair(conf_json, jax_cls, port_cls, x, y):
    """A JAX network and a port network from one config JSON, the port
    carrying the JAX network's weights, each trained two steps."""
    jnet = jax_cls(JCONF[jax_cls].from_json(conf_json)).init()
    tnet = port_cls(TCONF[port_cls].from_json(conf_json)).init("cpu")
    interop.params_from_jax(tnet, jnet.params, jnet.state)
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
    return tnet, jnet


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_zips_cross_between_the_packages(tmp_path, rng, kind):
    """A JAX zip read by the port and the port's rewrite of it: the same
    members, keys, dtypes and arrays as the JAX zip; a port zip read by
    the JAX package: the same outputs."""
    if kind == "mln":
        conf_json = _mln_conf().to_json()
        x, y = _data(rng, (4, 6, 6, 2), 3)
        jcls, tcls = JMLN, MultiLayerNetwork
    else:
        conf_json = small_resnet_json()
        x, y = _data(rng, (2, 16, 16, 3), 5)
        jcls, tcls = JCG, ComputationGraph
    tnet, jnet = _trained_pair(conf_json, jcls, tcls, x, y)
    jpath, tpath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jser.write_model(jnet, str(jpath))

    restored = restore_model(str(jpath), device="cpu")
    assert type(restored) is tcls
    assert restored.iteration == jnet.iteration == 2 and restored.epoch == 2
    write_model(restored, str(tpath))
    _same_members(tpath, jpath)

    # the port's own trained net, written and read by JAX
    write_model(tnet, str(tmp_path / "port_trained.zip"))
    back = jser.restore_model(str(tmp_path / "port_trained.zip"))
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               tnet.output(x).numpy(), atol=1e-5)
    tt = tnet.get_param_table()
    for k, v in back.get_param_table().items():
        np.testing.assert_array_equal(np.asarray(v), tt[k], err_msg=k)
    got = interop.opt_state_to_jax(tnet)
    want = back.opt_state
    entries = want.items() if isinstance(want, dict) else enumerate(want)
    for key, entry in entries:
        for slot, v in (entry.items() if entry else ()):
            if isinstance(v, dict):
                for p, leaf in v.items():
                    np.testing.assert_array_equal(
                        got[key][slot][p], np.asarray(leaf),
                        err_msg=f"{key}/{slot}/{p}")
            else:
                assert got[key][slot] == np.asarray(v)


def test_port_zip_round_trip_is_exact(tmp_path, rng):
    """write_model then restore_model on the port: params, running state,
    updater slots (dtypes included), iteration and epoch equal; the next
    step equal bit for bit; a restore without the updater starts fresh."""
    net = MultiLayerNetwork(_mln_conf()).init("cpu")
    x, y = _data(rng, (4, 6, 6, 2), 3)
    net.fit(x, y)
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    back = restore_multi_layer_network(path, device="cpu")
    assert (back.iteration, back.epoch) == (net.iteration, net.epoch)
    a, b = net.get_param_table(), back.get_param_table()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for key, st in net.state.items():
        assert sorted(st) == sorted(back.state[key])
        for k in st:
            assert torch.equal(st[k], back.state[key][k]), (key, k)
    sa = dict(tser._key_parts(interop.opt_state_to_jax(net)))
    sb = dict(tser._key_parts(interop.opt_state_to_jax(back)))
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert back.opt_state[2]["t"].dtype == torch.int32
    assert back.layers[0].to_json() == net.layers[0].to_json()
    net.fit(x, y)
    back.fit(x, y)
    for k, v in net.get_param_table().items():
        np.testing.assert_array_equal(v, back.get_param_table()[k], err_msg=k)
    fresh = restore_multi_layer_network(path, load_updater=False,
                                        device="cpu")
    assert float(fresh.opt_state[0]["m"]["W"].abs().max()) == 0.0


def test_graph_round_trip_keeps_channels_last(tmp_path, rng):
    """A restored graph's conv kernels and their slots are OIHW in
    channels_last memory, as `init` makes them."""
    net = ComputationGraph(
        ComputationGraphConfiguration.from_json(small_resnet_json())
    ).init("cpu")
    x, y = _data(rng, (2, 16, 16, 3), 5)
    net.fit(x, y)
    path = str(tmp_path / "g.zip")
    write_model(net, path)
    back = restore_computation_graph(path, device="cpu")
    name = next(n for n in back.topo if isinstance(back.layer(n), Conv2D))
    for t in (back.params[name]["W"], back.opt_state[name]["v"]["W"]):
        assert t.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(back.output(x).numpy(),
                                  net.output(x).numpy())


@pytest.mark.parametrize("name", READABLE)
def test_committed_fixture_restores_and_matches(name):
    net = restore_model(os.path.join(FIXDIR, name + ".zip"), device="cpu")
    x = EXPECTED[name + "_in"]
    np.testing.assert_allclose(net.output(x).numpy(),
                               EXPECTED[name + "_out"], atol=1e-5)
    assert net.iteration == 1 and net.epoch == 1


@pytest.mark.parametrize("name", READABLE)
def test_committed_fixture_keeps_training_as_jax_does(name):
    """One fit step from the restored fixture, with its restored updater
    slots, in both packages: params within 1e-5, and the output moves."""
    path = os.path.join(FIXDIR, name + ".zip")
    tnet = restore_model(path, device="cpu")
    jnet = jser.restore_model(path)
    tnet.draws = JaxKeys.for_net(tnet.conf.defaults.seed)
    x = EXPECTED[name + "_in"]
    out_shape = EXPECTED[name + "_out"].shape
    n_out = out_shape[-1]
    size = out_shape[:2] if len(out_shape) == 3 else len(x)
    y = np.eye(n_out, dtype=np.float32)[
        np.random.default_rng(0).integers(0, n_out, size)]
    tnet.fit(x, y)
    jnet.fit(x, y)
    jt = {f"{name}/{k}": v for name, p in jnet.params.items()
          for k, v in tser._key_parts(p)}
    tt = tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k, v in tt.items():
        np.testing.assert_allclose(v, np.asarray(jt[k]), atol=1e-5,
                                   err_msg=k)
    got = tnet.output(x).numpy()
    assert not np.allclose(got, EXPECTED[name + "_out"], atol=1e-7)
    assert tnet.iteration == 2


@pytest.mark.parametrize("name", sorted(ONCE_REFUSED))
def test_fixtures_naming_unported_classes_raise(name):
    """The dropout and weight-noise fixtures, once refused, restore: each
    layer's objects revived as the port's classes with their
    schedules."""
    path = os.path.join(FIXDIR, name + ".zip")
    net = restore_model(path, device="cpu")
    jnet = jser.restore_model(path)
    for i, drop, noise in ONCE_REFUSED[name]:
        layer = net.layers[i]
        assert type(layer.dropout).__name__ == drop
        assert (type(layer.weight_noise).__name__ if noise else None) == noise
        assert layer.to_json() == jnet.layers[i].to_json()
    assert net.conf.to_json() == jnet.conf.to_json()


def test_bidirectional_fixture_trains_three_steps_as_jax_does():
    """mln_bidir_lstm (GravesBidirectionalLSTM(10) with tanh cells, so
    rows 5 and 6's plain versions for both halves, and an RnnOutput; Adam)
    restored with its Adam slots in both packages: 3 fit steps on its
    committed input with row 1 masked from its middle on, scores, params
    and slots as JAX's."""
    path = os.path.join(FIXDIR, "mln_bidir_lstm.zip")
    tnet, jnet = restore_model(path, device="cpu"), jser.restore_model(path)
    assert type(tnet.layers[0]).__name__ == "GravesBidirectionalLSTM"
    x = EXPECTED["mln_bidir_lstm_in"]
    b, t = x.shape[:2]
    y = np.eye(4, dtype=np.float32)[
        np.random.default_rng(1).integers(0, 4, (b, t))]
    fm = np.ones((b, t), np.float32)
    fm[-1, t // 2:] = 0.0
    for _ in range(3):
        tnet.fit(DataSet(x, y, fm, fm))
        jnet.fit(jds_mod.DataSet(x, y, fm, fm))
        assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    jt = {f"{name}/{k}": v for name, p in jnet.params.items()
          for k, v in tser._key_parts(p)}
    for k, v in tnet.get_param_table().items():
        np.testing.assert_allclose(v, np.asarray(jt[k]), atol=1e-5,
                                   err_msg=k)
    got = dict(tser._key_parts(interop.opt_state_to_jax(tnet)))
    for k, want in tser._key_parts(jnet.opt_state):
        want = np.asarray(want, np.float64)
        assert np.abs(got[k] - want).max() <= 1e-4 * max(
            np.abs(want).max(), 1e-30), k
    assert tnet.iteration == jnet.iteration == 4


def test_missing_array_and_wrong_shape_refuse(tmp_path, rng):
    net = MultiLayerNetwork(_mln_conf()).init("cpu")
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    members = _members(path)
    coeff = dict(members["coefficients.npz"])
    del coeff["layer_3/b"]
    bad = tmp_path / "missing.zip"
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(bad, "w") as zout:
        for n in zin.namelist():
            if n != "coefficients.npz":
                zout.writestr(n, zin.read(n))
        buf = io.BytesIO()
        np.savez(buf, **coeff)
        zout.writestr("coefficients.npz", buf.getvalue())
    with pytest.raises(KeyError, match="layer_3/b"):
        restore_multi_layer_network(str(bad), device="cpu")
    coeff = dict(members["coefficients.npz"])
    coeff["layer_0/W"] = np.zeros((3, 3, 2, 5), np.float32)
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(bad, "w") as zout:
        for n in zin.namelist():
            if n != "coefficients.npz":
                zout.writestr(n, zin.read(n))
        buf = io.BytesIO()
        np.savez(buf, **coeff)
        zout.writestr("coefficients.npz", buf.getvalue())
    with pytest.raises(ValueError, match="shape"):
        restore_multi_layer_network(str(bad), device="cpu")


def test_npz_keys_are_jax_tree_paths():
    tree = [{"m": {"W": np.ones(2), "b": np.zeros(1)}, "t": np.int32(3)},
            (), {"v": {}}, {"g2": {"b": np.ones(1), "R": np.ones(1)}}]
    assert [k for k, _ in tser._key_parts(tree)] == \
        ["0/m/W", "0/m/b", "0/t", "3/g2/R", "3/g2/b"]


def test_scores_continue_after_restore(tmp_path, rng):
    """score() of a restored network equals the original's."""
    net = MultiLayerNetwork(_mln_conf()).init("cpu")
    x, y = _data(rng, (4, 6, 6, 2), 3)
    net.fit(x, y)
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    back = restore_model(path, device="cpu")
    assert back.score(DataSet(x, y)) == net.score(DataSet(x, y))


def test_zips_with_dropout_and_weight_noise_cross_between_the_packages(
        tmp_path, rng):
    """A network with dropout and weight-noise objects and schedules,
    trained in the JAX package and written there: the port restores it and
    writes the same members; the port's own trained copy (the same keys
    replayed) written by the port is restored by the JAX package with the
    same params and outputs."""
    from deeplearning4j_tpu_torch.nn import dropout as tdrop
    from deeplearning4j_tpu_torch.nn import schedules as tsched
    from deeplearning4j_tpu_torch.nn import weightnoise as twn

    conf_json = NeuralNetConfiguration(
        seed=9, updater=updaters.Adam(learning_rate=1e-2)).list([
            Conv2D(kernel_size=(3, 3), n_out=4, convolution_mode="same",
                   activation="relu", weight_noise=twn.DropConnect(
                       0.9, p_schedule=tsched.ExponentialSchedule(0.99))),
            Subsampling2D(kernel_size=(2, 2), stride=(2, 2)),
            Dense(n_out=6, activation="selu",
                  dropout=tdrop.AlphaDropout(0.9),
                  weight_noise=twn.WeightNoise(stddev=0.01)),
            Dense(n_out=5, activation="tanh", dropout=tdrop.GaussianDropout(
                0.2, rate_schedule=tsched.MapSchedule({1: 0.1}))),
            Output(n_out=3, loss="mcxent"),
        ]).set_input_type(it.convolutional(6, 6, 2)).to_json()
    x, y = _data(rng, (4, 6, 6, 2), 3)
    jnet = JMLN(JConf.from_json(conf_json)).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf_json)).init("cpu")
    interop.params_from_jax(tnet, jnet.params, jnet.state)
    tnet.draws = JaxKeys.for_net(9)
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
    jpath, tpath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jser.write_model(jnet, str(jpath))
    restored = restore_model(str(jpath), device="cpu")
    write_model(restored, str(tpath))
    _same_members(tpath, jpath)
    write_model(tnet, str(tmp_path / "port_trained.zip"))
    back = jser.restore_model(str(tmp_path / "port_trained.zip"))
    assert back.conf.to_json() == jnet.conf.to_json()
    tt = tnet.get_param_table()
    for k, v in back.get_param_table().items():
        np.testing.assert_array_equal(np.asarray(v), tt[k], err_msg=k)
        np.testing.assert_allclose(tt[k], np.asarray(
            jnet.get_param_table()[k]), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               tnet.output(x).numpy(), atol=1e-5)
