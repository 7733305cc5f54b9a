"""The port's DL4J ModelSerializer zip import against the JAX package's.

Every zip is restored by both packages (the port on the CPU) and the port
is held to the JAX network: the same params and running state in the
interchange layout and the same updater slots (`interop.opt_state_to_jax`),
bit for bit, and outputs within 1e-6 absolute (1e-5 at the full width of
the char-RNN: float32 sums over 256 units in another order). The layout
tests of tests/test_dl4j_import.py are mirrored on the port: they are
analytic, computed from the reference's ParamInitializer contracts rather
than from either importer.
"""
import importlib.util
import io
import json
import os
import struct
import warnings
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import dl4j as jd
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet, NormalizerStandardize
from deeplearning4j_tpu_torch.modelimport import dl4j as td
from deeplearning4j_tpu_torch.modelimport import (
    restore_computation_graph,
    restore_multi_layer_network,
    restore_normalizer,
)
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    GravesLSTM,
    Output,
    RnnOutput,
    Subsampling2D,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "dl4j")
EXP = np.load(os.path.join(FIX, "expected_outputs.npz"))

# fixture -> (input key, output key, input type or None)
MLN_FIXTURES = {
    "mlp_nesterovs": ("mlp_x", "mlp_y", None),
    "mlp_half": ("mlp_x", "mlp_y", None),
    "mlp_with_normalizer": ("mlp_x", "mlp_y", None),
    "conv_pool_bn": ("conv_x", "conv_y", (5, 5, 2)),
    "graves_lstm": ("lstm_x", "lstm_y", None),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _restore_both(path, input_type=None, load_updater=False, graph=False):
    if graph:
        return (restore_computation_graph(path, load_updater=load_updater,
                                          device="cpu"),
                jd.restore_computation_graph(path,
                                             load_updater=load_updater))
    t_in = it.convolutional(*input_type) if input_type else None
    j_in = jit.convolutional(*input_type) if input_type else None
    return (restore_multi_layer_network(path, t_in, load_updater,
                                        device="cpu"),
            jd.restore_multi_layer_network(path, j_in, load_updater))


def _same_weights(tnet, jnet):
    tt, jt = tnet.get_param_table(), jnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)
    for k, st in jnet.state.items():
        assert sorted(tnet.state[k]) == sorted(st), k
        for s, v in st.items():
            np.testing.assert_array_equal(tnet.state[k][s].numpy(),
                                          np.asarray(v), err_msg=f"{k}/{s}")


def _flat_slots(slots):
    """{'entry/slot/path': array} of an opt_state in the JAX package's
    containers (a list or a dict of entries)."""
    out = {}
    entries = slots.items() if isinstance(slots, dict) else enumerate(slots)
    for key, entry in entries:
        if not entry:
            continue
        for slot, v in entry.items():
            if isinstance(v, dict):
                stack = [(f"{key}/{slot}", v)]
                while stack:
                    pre, node = stack.pop()
                    for k, leaf in node.items():
                        if isinstance(leaf, dict):
                            stack.append((f"{pre}/{k}", leaf))
                        else:
                            out[f"{pre}/{k}"] = np.asarray(leaf)
            else:
                out[f"{key}/{slot}"] = np.asarray(v)
    return out


def _same_slots(tnet, jnet):
    got = _flat_slots(interop.opt_state_to_jax(tnet))
    want = _flat_slots(jnet.opt_state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", sorted(MLN_FIXTURES))
def test_mln_fixture_matches_jax(name):
    xk, yk, in_type = MLN_FIXTURES[name]
    tnet, jnet = _restore_both(os.path.join(FIX, name + ".zip"), in_type,
                               load_updater=True)
    assert isinstance(tnet, MultiLayerNetwork)
    assert [type(l).__name__ for l in tnet.layers] == \
        [type(l).__name__ for l in jnet.layers]
    _same_weights(tnet, jnet)
    _same_slots(tnet, jnet)
    got = tnet.output(EXP[xk]).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.output(EXP[xk])),
                               atol=1e-6)
    np.testing.assert_allclose(got, EXP[yk], atol=1e-6)


def test_graph_fixture_matches_jax():
    tnet, jnet = _restore_both(os.path.join(FIX, "graph_diamond.zip"),
                               graph=True)
    assert isinstance(tnet, ComputationGraph)
    _same_weights(tnet, jnet)
    got = tnet.output(EXP["graph_x"]).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.output(EXP["graph_x"])),
                               atol=1e-6)
    np.testing.assert_allclose(got, EXP["graph_y"], atol=1e-6)


def test_graph_flat_order_is_the_reference_kahn_order(tmp_path, rng):
    """A two-input graph whose reference order (FIFO Kahn seeded with the
    network inputs in order) differs from the port's own topological order
    (the vertices in insertion order): the flat vector is sliced b, a, out
    while the port's runtime walks a, b. Both packages restore the same
    weights, and b's W is the first 20 values in 'f' order."""
    def dense(act, n_in, n_out, kind="dense", **extra):
        return {"LayerVertex": {"layerConf": {"layer": {kind: dict(
            activationFunction=act, nin=n_in, nout=n_out, updater="SGD",
            learningRate=0.1, **extra)}}, "preProcessor": None}}

    conf = {"networkInputs": ["in1", "in2"], "networkOutputs": ["out"],
            "vertices": {"a": dense("relu", 4, 5), "b": dense("tanh", 4, 5),
                         "m": {"MergeVertex": {}},
                         "out": dense("softmax", 10, 3, "output",
                                      lossFunction="MCXENT")},
            "vertexInputs": {"a": ["in2"], "b": ["in1"], "m": ["a", "b"],
                             "out": ["m"]}}
    flat = rng.normal(0, 0.5, 2 * 25 + 33).astype(np.float32)
    buf = io.BytesIO()
    td.write_nd4j_array(buf, flat[None, :], order="f")
    path = tmp_path / "two_inputs.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", buf.getvalue())
    tnet, jnet = _restore_both(str(path), graph=True)
    assert tnet.topo[:2] == ["a", "b"]
    assert td._reference_topological_order(
        conf["networkInputs"], conf["vertexInputs"]) == ["b", "a", "m", "out"]
    _same_weights(tnet, jnet)
    np.testing.assert_array_equal(tnet.get_param_table()["b/W"],
                                  np.reshape(flat[:20], (4, 5), order="F"))
    x1, x2 = (rng.normal(0, 1, (3, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tnet.output(x1, x2).numpy(),
                               np.asarray(jnet.output(x1, x2)), atol=1e-6)


def test_reference_topological_order_is_kahn_fifo():
    """Tie-breaking, duplicate input edges and cycles, as in JAX."""
    cases = [(["in"], {"a": ["in"], "b": ["in"], "m": ["a", "b"],
                       "out": ["m"]}),
             (["x"], {"a": ["x"], "sq": ["a", "a"], "out": ["sq"]}),
             (["x"], {"p": ["x"], "q": ["x"], "r": ["p"], "s": ["q", "r"],
                      "t": ["s", "x"]})]
    for ins, vin in cases:
        assert td._reference_topological_order(ins, vin) == \
            jd._reference_topological_order(ins, vin)
    with pytest.raises(ValueError, match="cycle"):
        td._reference_topological_order(["x"], {"a": ["x", "b"], "b": ["a"]})


# ------------------------------------------------------- analytic layouts
def test_mlp_config_and_flat_layout_analytic():
    """RegressionTest080's MLP: linspace(1..41) params, so W0[i, j] ==
    1 + i + j*nIn ('f' order, DefaultParamInitializer.java:116-143)."""
    net = restore_multi_layer_network(os.path.join(FIX, "mlp_nesterovs.zip"),
                                      device="cpu")
    l0, l1 = net.layers
    assert isinstance(l0, Dense) and l0.activation == "relu"
    assert (l0.n_in, l0.n_out, l0.weight_init) == (3, 4, "xavier")
    assert isinstance(l0.updater, updaters.Nesterovs)
    assert l0.updater.learning_rate == pytest.approx(0.15)
    assert l0.updater.momentum == pytest.approx(0.9)
    assert isinstance(l1, Output) and l1.activation == "softmax"
    assert (l1.loss, l1.n_in, l1.n_out) == ("mcxent", 4, 5)
    W0 = net.params["layer_0"]["W"].numpy()
    for i in range(3):
        for j in range(4):
            assert W0[i, j] == 1 + i + j * 3
    np.testing.assert_array_equal(net.params["layer_0"]["b"].numpy(),
                                  [13, 14, 15, 16])
    W1 = net.params["layer_1"]["W"].numpy()
    assert W1[0, 0] == 17 and W1[1, 0] == 18 and W1[0, 1] == 21
    np.testing.assert_array_equal(net.params["layer_1"]["b"].numpy(),
                                  [37, 38, 39, 40, 41])


def test_conv_bn_config_and_weight_orientation_analytic():
    """Bias first, then 'c'-order [nOut, nIn, kh, kw] conv weights
    (ConvolutionParamInitializer.java:118-153): in the interchange layout
    W[kh, kw, cin, cout] == flat[3 + ((cout*nIn + cin)*2 + kh)*2 + kw];
    BatchNorm's mean/var land in the running state."""
    net = restore_multi_layer_network(os.path.join(FIX, "conv_pool_bn.zip"),
                                      it.convolutional(5, 5, 2),
                                      device="cpu")
    l0 = net.layers[0]
    assert isinstance(l0, Conv2D) and l0.kernel_size == (2, 2)
    assert l0.activation == "relu"
    assert isinstance(l0.updater, updaters.Adam)
    assert l0.updater.learning_rate == pytest.approx(0.01)
    assert isinstance(net.layers[1], Subsampling2D)
    assert net.layers[1].pooling_type == "max"
    assert isinstance(net.layers[2], BatchNorm)
    assert float(net.state["layer_2"]["var"].min()) > 0
    assert 3 in net.conf.input_preprocessors
    rng = np.random.default_rng(7)
    bias = rng.normal(0, 0.5, 3)
    flat_w = rng.normal(0, 0.5, 24)
    table = net.get_param_table()
    W, b = table["layer_0/W"], table["layer_0/b"]
    np.testing.assert_allclose(b, bias, atol=1e-7)
    for cout in range(3):
        for cin in range(2):
            for kh in range(2):
                for kw in range(2):
                    fi = ((cout * 2 + cin) * 2 + kh) * 2 + kw
                    np.testing.assert_allclose(W[kh, kw, cin, cout],
                                               flat_w[fi], atol=1e-7)


def test_lstm_gate_permutation_analytic():
    """iW is [nIn, 4n] 'f' with gate blocks (g, f, o, i); the port's W
    blocks are (i, f, g, o); the peephole columns 4n+0/1/2 are f, o, i."""
    n = 4
    rng = np.random.default_rng(11)
    iw = np.reshape(rng.normal(0, 0.4, 3 * 4 * n), (3, 4 * n), order="F")
    rw = np.reshape(rng.normal(0, 0.4, n * (4 * n + 3)), (n, 4 * n + 3),
                    order="F")
    net = restore_multi_layer_network(os.path.join(FIX, "graves_lstm.zip"),
                                      device="cpu")
    assert isinstance(net.layers[0], GravesLSTM)
    assert isinstance(net.layers[1], RnnOutput)
    p = {k: v.numpy() for k, v in net.params["layer_0"].items()}
    for blk, src in enumerate((3, 1, 0, 2)):
        np.testing.assert_allclose(p["W"][:, blk * n:(blk + 1) * n],
                                   iw[:, src * n:(src + 1) * n], atol=1e-7)
        np.testing.assert_allclose(p["R"][:, blk * n:(blk + 1) * n],
                                   rw[:, src * n:(src + 1) * n], atol=1e-7)
    for k, col in (("pf", 0), ("po", 1), ("pi", 2)):
        np.testing.assert_allclose(p[k], rw[:, 4 * n + col], atol=1e-7)


def _square_conv_zip(path, rng):
    """A conv net whose kernel has nIn == nOut and kh == kw, so its HWIO
    and OIHW forms have the same size: [conv 3->3 2x2, cnnToFeedForward,
    output 12->2]."""
    conf = {"backprop": True, "backpropType": "Standard", "confs": [
        {"layer": {"convolution": {
            "activationFn": {"Identity": {}}, "nin": 3, "nout": 3,
            "kernelSize": [2, 2], "stride": [1, 1], "padding": [0, 0],
            "convolutionMode": "Truncate", "hasBias": True,
            "updater": "SGD", "learningRate": 0.1}}},
        {"layer": {"output": {
            "activationFn": {"Softmax": {}}, "lossFunction": "MCXENT",
            "nin": 12, "nout": 2, "updater": "SGD", "learningRate": 0.1}}},
    ], "inputPreProcessors": {"1": {"cnnToFeedForward": {
        "inputHeight": 2, "inputWidth": 2, "numChannels": 3}}}}
    flat = rng.normal(0, 0.5, 3 + 36 + 24 + 2).astype(np.float32)
    buf = io.BytesIO()
    td.write_nd4j_array(buf, flat[None, :], order="f")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", buf.getvalue())


def test_square_conv_kernel_goes_through_from_interchange(tmp_path, rng):
    """Both packages agree on a kernel whose two layouts have one size;
    a copy that skipped `from_interchange` (HWIO values in the OIHW
    tensor) would fail that comparison."""
    path = tmp_path / "square_conv.zip"
    _square_conv_zip(path, rng)
    tnet, jnet = _restore_both(str(path), (3, 3, 3))
    _same_weights(tnet, jnet)
    x = rng.normal(0, 1, (2, 3, 3, 3)).astype(np.float32)
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(tnet.output(x).numpy(), want, atol=1e-6)
    hwio = jnet.params["layer_0"]["W"]
    w = tnet.params["layer_0"]["W"]
    assert tuple(hwio.shape) != tuple(w.shape) and hwio.size == w.numel()
    with torch.no_grad():
        w.copy_(torch.from_numpy(np.array(hwio)).reshape(w.shape))
    assert np.abs(tnet.output(x).numpy() - want).max() > 1e-3


# ------------------------------------------------------------ updater state
def _rewrite(src, dst, conf=None, updater=None):
    """Copy the zip `src` to `dst` with another configuration and/or
    updaterState.bin vector."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            if name == "configuration.json" and conf is not None:
                zout.writestr(name, json.dumps(conf))
            elif name == "updaterState.bin" and updater is not None:
                continue
            else:
                zout.writestr(name, zin.read(name))
        if updater is not None:
            buf = io.BytesIO()
            if isinstance(updater, bytes):
                buf.write(updater)
            else:
                td.write_nd4j_array(buf, np.asarray(updater)[None, :],
                                    order="f")
            zout.writestr("updaterState.bin", buf.getvalue())


def test_mlp_updater_state_analytic_and_used():
    """The fixture's Nesterovs momentum is linspace(1..41) over the param
    layout (RegressionTest080.java:80-83), and the restored moments are
    used: one step differs from a fresh-moment restore, as in JAX."""
    path = os.path.join(FIX, "mlp_nesterovs.zip")
    net = restore_multi_layer_network(path, load_updater=True, device="cpu")
    v0 = net.opt_state[0]["v"]["W"].numpy()
    for i in range(3):
        for j in range(4):
            assert v0[i, j] == 1 + i + j * 3
    np.testing.assert_array_equal(net.opt_state[1]["v"]["b"].numpy(),
                                  [37, 38, 39, 40, 41])
    fresh = restore_multi_layer_network(path, device="cpu")
    jnet = jd.restore_multi_layer_network(path, load_updater=True)
    x = np.ones((4, 3), np.float32)
    y = np.eye(5, dtype=np.float32)[[0, 1, 2, 3]]
    for n in (net, fresh, jnet):
        n.fit(x, y)
    np.testing.assert_allclose(net.get_param_table()["layer_0/W"],
                               np.asarray(jnet.params["layer_0"]["W"]),
                               rtol=1e-6, atol=1e-6)
    assert not np.allclose(net.get_param_table()["layer_0/W"],
                           fresh.get_param_table()["layer_0/W"])


def test_graph_updater_state_matches_jax(tmp_path):
    """A graph's state walks the reference order, as its params do
    (Nesterovs momentum = linspace(1..83)); a paramless dropout vertex in
    the chain does not veto the import."""
    with zipfile.ZipFile(os.path.join(FIX, "graph_diamond.zip")) as zf:
        conf = json.loads(zf.read("configuration.json"))
    for v in conf["vertices"].values():
        lc = (next(iter(v.values())).get("layerConf") or {}).get("layer")
        if lc:
            next(iter(lc.values())).update(updater="NESTEROVS", momentum=0.9,
                                           learningRate=0.1)
    conf["vertices"]["drop"] = {"LayerVertex": {
        "layerConf": {"layer": {"dropout": {}}}, "preProcessor": None}}
    conf["vertexInputs"]["drop"] = ["m"]
    conf["vertexInputs"]["out"] = ["drop"]
    path = tmp_path / "diamond_nesterovs.zip"
    _rewrite(os.path.join(FIX, "graph_diamond.zip"), path, conf,
             np.linspace(1, 83, 83))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tnet, jnet = _restore_both(str(path), load_updater=True, graph=True)
    _same_slots(tnet, jnet)
    va = interop.opt_state_to_jax(tnet)["a"]["v"]["W"]
    for i in range(4):
        for j in range(5):
            assert va[i, j] == 1 + i + j * 4
    np.testing.assert_array_equal(tnet.opt_state["out"]["v"]["b"].numpy(),
                                  [81, 82, 83])


def _adam_bn_conf(lock=False, iteration=0):
    adam = {"updater": "ADAM", "learningRate": 0.01, "adamMeanDecay": 0.9,
            "adamVarDecay": 0.999}
    return {"backprop": True, "backpropType": "Standard", "confs": [
        {"iterationCount": iteration, "layer": {"dense": dict(
            adam, activationFunction="relu", nin=2, nout=3)}},
        {"layer": {"batchNormalization": dict(
            adam, nin=3, nout=3, decay=0.9, eps=1e-5, lockGammaBeta=lock)}},
        {"layer": {"output": dict(
            adam, activationFunction="softmax", lossFunction="MCXENT", nin=3,
            nout=2)}}]}


@pytest.mark.parametrize("lock", [False, True], ids=["bn", "bn-locked"])
def test_adam_slots_and_batchnorm_blocks_match_jax(tmp_path, lock):
    """Adam's [m, v] per block, BatchNorm ending each block (also with
    lockGammaBeta, which leaves it no params), and iterationCount as
    net.iteration and Adam's step count."""
    n_params, blocks = (23, (9, 8)) if lock else (29, (15, 8))
    state = np.concatenate([np.full(blocks[0], 1.0), np.full(blocks[0], 2.0),
                            np.full(blocks[1], 3.0), np.full(blocks[1], 4.0)])
    path = tmp_path / "adam_bn.zip"
    buf = io.BytesIO()
    td.write_nd4j_array(buf, np.linspace(1, n_params, n_params)[None, :],
                        order="f")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json",
                    json.dumps(_adam_bn_conf(lock, iteration=7)))
        zf.writestr("coefficients.bin", buf.getvalue())
    _rewrite(path, tmp_path / "adam_bn_state.zip", updater=state)
    tnet, jnet = _restore_both(str(tmp_path / "adam_bn_state.zip"),
                               load_updater=True)
    _same_weights(tnet, jnet)
    _same_slots(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 7
    assert int(tnet.opt_state[0]["t"]) == 7
    assert float(tnet.opt_state[2]["m"]["W"].min()) == 3.0
    assert float(tnet.opt_state[2]["v"]["b"].min()) == 4.0


def test_heterogeneous_updaters_warn_and_keep_fresh_slots(tmp_path):
    conf = _adam_bn_conf()
    conf["confs"][2]["layer"]["output"].update(updater="NESTEROVS",
                                               momentum=0.9)
    path = tmp_path / "mixed.zip"
    buf = io.BytesIO()
    td.write_nd4j_array(buf, np.linspace(1, 29, 29)[None, :], order="f")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", buf.getvalue())
    _rewrite(path, tmp_path / "mixed_state.zip", updater=np.ones(38))
    with pytest.warns(UserWarning, match="uniform"):
        tnet = restore_multi_layer_network(str(tmp_path / "mixed_state.zip"),
                                           load_updater=True, device="cpu")
    with pytest.warns(UserWarning, match="uniform"):
        jnet = jd.restore_multi_layer_network(
            str(tmp_path / "mixed_state.zip"), load_updater=True)
    _same_slots(tnet, jnet)
    assert float(tnet.opt_state[0]["m"]["W"].abs().max()) == 0.0


def test_garbage_updater_state_warns(tmp_path):
    dst = tmp_path / "garbage.zip"
    _rewrite(os.path.join(FIX, "mlp_nesterovs.zip"), dst, updater=b"\x00")
    with pytest.warns(UserWarning, match="updater state"):
        net = restore_multi_layer_network(str(dst), load_updater=True,
                                          device="cpu")
    assert float(net.opt_state[0]["v"]["W"].abs().max()) == 0.0


# ---------------------------------------------------- buffers, the clock
def test_nd4j_arrays_match_jax_bytes():
    """The port writes the JAX package's bytes and reads its arrays back,
    in both orders and every element encoding it writes."""
    rng = np.random.default_rng(0)
    for shape, order in [((7,), "c"), ((3, 5), "f"), ((2, 3, 4), "c"),
                         ((1, 41), "f")]:
        a = rng.normal(0, 1, shape).astype(np.float32)
        for dtype in ("FLOAT", "HALF", "DOUBLE"):
            tb, jb = io.BytesIO(), io.BytesIO()
            td.write_nd4j_array(tb, a, order=order, dtype=dtype)
            jd.write_nd4j_array(jb, a, order=order, dtype=dtype)
            assert tb.getvalue() == jb.getvalue()
            tb.seek(0)
            jb.seek(0)
            np.testing.assert_array_equal(td.read_nd4j_array(tb),
                                          jd.read_nd4j_array(jb))


def test_half_coefficients_match_float():
    """HALF buffers decode (big-endian float16): linspace(1..41) is exact
    in float16, so the weights equal the FLOAT fixture's."""
    a = restore_multi_layer_network(os.path.join(FIX, "mlp_nesterovs.zip"),
                                    device="cpu").get_param_table()
    b = restore_multi_layer_network(os.path.join(FIX, "mlp_half.zip"),
                                    device="cpu").get_param_table()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_compressed_buffer_raises_the_jax_diagnostic():
    buf = io.BytesIO()
    td._write_utf(buf, "HEAP")
    buf.write(struct.pack(">i", 4))
    td._write_utf(buf, "COMPRESSED")
    msgs = []
    for mod in (td, jd):
        buf.seek(0)
        with pytest.raises(ValueError, match="compression") as e:
            mod._read_buffer(buf)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_iteration_count_restores_the_clock(tmp_path):
    with zipfile.ZipFile(os.path.join(FIX, "mlp_nesterovs.zip")) as zf:
        conf = json.loads(zf.read("configuration.json"))
    conf["confs"][1]["iterationCount"] = 1234
    path = tmp_path / "clock.zip"
    _rewrite(os.path.join(FIX, "mlp_nesterovs.zip"), path, conf)
    tnet, jnet = _restore_both(str(path))
    assert tnet.iteration == jnet.iteration == 1234
    tnet.fit(np.ones((2, 3), np.float32), np.eye(5, dtype=np.float32)[:2])
    assert tnet.iteration == 1235


def test_count_mismatch_and_non_model_zips_refuse(tmp_path):
    with zipfile.ZipFile(os.path.join(FIX, "mlp_nesterovs.zip")) as zf:
        conf = zf.read("configuration.json")
    bad = tmp_path / "bad.zip"
    buf = io.BytesIO()
    td.write_nd4j_array(buf, np.zeros((1, 40), np.float32), order="f")
    with zipfile.ZipFile(bad, "w") as zf:
        zf.writestr("configuration.json", conf)
        zf.writestr("coefficients.bin", buf.getvalue())
    with pytest.raises(ValueError, match="exhausted|consumed"):
        restore_multi_layer_network(str(bad), device="cpu")
    notmodel = tmp_path / "x.zip"
    with zipfile.ZipFile(notmodel, "w") as zf:
        zf.writestr("readme.txt", "hi")
    with pytest.raises(ValueError, match="configuration.json"):
        restore_multi_layer_network(str(notmodel), device="cpu")


def _dl4j_vertex(kind, n_i, n_o, **extra):
    return {"LayerVertex": {"layerConf": {"layer": {kind: dict(
        nin=n_i, nout=n_o, updater="SGD", learningRate=0.1, **extra)}},
        "preProcessor": None}}


def test_graph_with_last_time_step_vertex_imports_as_jax(tmp_path):
    """in -> gravesLSTM(4 -> 5) -> LastTimeStepVertex (maskArrayInputName
    "in") -> output(5 -> 2) as a DL4J zip: both importers build the same
    configuration, the same params from the flat vector, and the same
    output; then 2 SGD steps on a masked batch (the last step taken at
    each row's live length) agree."""
    conf = {"networkInputs": ["in"], "networkOutputs": ["out"],
            "vertices": {
                "lstm": _dl4j_vertex("gravesLSTM", 4, 5,
                                     activationFn={"TanH": {}},
                                     gateActivationFn={"Sigmoid": {}},
                                     forgetGateBiasInit=1.0),
                "last": {"LastTimeStepVertex": {"maskArrayInputName": "in"}},
                "out": _dl4j_vertex("output", 5, 2,
                                    activationFn={"Softmax": {}},
                                    lossFunction="MCXENT")},
            "vertexInputs": {"lstm": ["in"], "last": ["lstm"],
                             "out": ["last"]}}
    rng = np.random.default_rng(9)
    flat = rng.normal(0, 0.5, 4 * 20 + 5 * 23 + 20 + 5 * 2 + 2).astype(
        np.float32)
    path = tmp_path / "g.zip"
    buf = io.BytesIO()
    td.write_nd4j_array(buf, flat[None, :], order="f")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", buf.getvalue())
    tnet = td.restore_computation_graph(str(path), device="cpu")
    jnet = jd.restore_computation_graph(str(path))
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tnet.conf.vertices["last"].mask_input == "in"
    jt = jnet.get_param_table()
    for k, v in tnet.get_param_table().items():
        np.testing.assert_array_equal(v, np.asarray(jt[k]), err_msg=k)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    fm = (np.arange(6)[None] < np.array([[6], [2], [4]])).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1]]
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    for _ in range(2):
        tnet.fit(MultiDataSet([x], [y], [fm], None))
        jnet.fit(JMDS([x], [y], [fm], None))
        assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    jt = jnet.get_param_table()
    for k, v in tnet.get_param_table().items():
        np.testing.assert_allclose(v, np.asarray(jt[k]), atol=1e-5,
                                   err_msg=k)


def test_one_input_duplicate_to_time_series_vertex_as_jax():
    """ROADMAP C.10: the reference's DuplicateToTimeSeriesVertex has one
    input and names its time source by `inputName`; both importers drop
    the field and keep the one wire, and both refuse the network with a
    ValueError: the vertex takes two inputs."""
    conf = {"networkInputs": ["in", "dec"], "networkOutputs": ["out"],
            "vertices": {
                "a": _dl4j_vertex("dense", 4, 6,
                                  activationFunction="tanh"),
                "dup": {"DuplicateToTimeSeriesVertex": {"inputName": "dec"}},
                "out": _dl4j_vertex("rnnoutput", 6, 2,
                                    activationFunction="softmax",
                                    lossFunction="MCXENT")},
            "vertexInputs": {"a": ["in"], "dup": ["a"], "out": ["dup"]}}
    from deeplearning4j_tpu.models import ComputationGraph as JCG

    tconf, _ = td.graph_configuration_from_json(
        json.dumps(conf), [it.feed_forward(4), it.recurrent(3, 5)])
    jconf, _ = jd.graph_configuration_from_json(
        json.dumps(conf), [jit.feed_forward(4), jit.recurrent(3, 5)])
    assert tconf.vertices["dup"].to_json() == \
        jconf.vertices["dup"].to_json() == \
        {"type": "DuplicateToTimeSeriesVertex"}
    assert tconf.vertex_inputs["dup"] == jconf.vertex_inputs["dup"] == ["a"]
    with pytest.raises(ValueError, match="takes 2 input"):
        ComputationGraph(tconf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX analyzer's DLA004
        with pytest.raises(ValueError, match="takes 2 input"):
            JCG(jconf)


def test_dropout_field_builds_as_jax_and_fit_refuses():
    """A dropOut field builds the layer with its retain probability, as
    JAX does, and fit trains with it: 3 steps with the JAX network's keys
    replayed into the port's draws equal the JAX fit."""
    text = json.dumps({"confs": [
        {"layer": {"dense": {"activationFn": {"ReLU": {}}, "nin": 3,
                             "nout": 4, "dropOut": 0.5,
                             "iUpdater": {"Adam": {"learningRate": 0.005,
                                                   "beta1": 0.85}},
                             "gradientNormalization": "ClipL2PerLayer",
                             "gradientNormalizationThreshold": 2.5}}},
        {"layer": {"output": {"activationFn": {"Softmax": {}},
                              "lossFunction": "MCXENT", "nin": 4,
                              "nout": 2}}}]})
    tconf = td.configuration_from_json(text)
    jconf = jd.configuration_from_json(text)
    assert tconf.layers[0].to_json() == jconf.layers[0].to_json()
    import jax

    from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
    from torch_keys import JaxKeys

    net = MultiLayerNetwork(tconf).init("cpu")
    jnet = JMLN(jconf).init()
    interop.params_from_jax(net, jax.tree_util.tree_map(np.asarray,
                                                        jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    net.draws = JaxKeys.for_net(jconf.defaults.seed)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    for _ in range(3):
        net.fit(x, y)
        jnet.fit(x, y)
        assert abs(net.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    got = net.get_param_table()
    for k, v in jnet.get_param_table().items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_normalizer_bin_restores_and_feeds_the_network():
    path = os.path.join(FIX, "mlp_with_normalizer.zip")
    norm = restore_normalizer(path)
    assert isinstance(norm, NormalizerStandardize) and not norm.fit_labels
    np.testing.assert_array_equal(norm.mean.numpy(), [0.5, -1.0, 2.0])
    np.testing.assert_array_equal(norm.std.numpy(), [2.0, 0.5, 1.0])
    assert restore_normalizer(os.path.join(FIX, "mlp_nesterovs.zip")) is None
    net = restore_multi_layer_network(path, device="cpu")
    x = EXP["mlp_x"]
    got = net.output(norm.transform(DataSet(x, np.zeros((4, 5)))).features)
    want = net.output((x - norm.mean.numpy()) / norm.std.numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)


# ----------------------------------------------------- the char-RNN path
def test_full_width_char_rnn_zip_matches_jax(tmp_path):
    """chip_smoke.py's DL4J char-RNN (zoo TextGenerationLSTM at full width,
    888,653 params, legacy RMSPROP with its state, tBPTT 50/50,
    iterationCount 1000), restored by both packages: the same weights and
    RMSProp slots, outputs on 2 x 20 one-hot characters within 1e-5."""
    cs = _chip_smoke()
    path = str(tmp_path / "char_rnn.zip")
    flat, g2 = cs.write_char_rnn_zip(np, path, seed=3)
    assert flat.size == g2.size == cs.CHAR_RNN_PARAMS
    tnet, jnet = _restore_both(path, load_updater=True)
    assert tnet.num_params() == cs.CHAR_RNN_PARAMS
    assert tnet.iteration == jnet.iteration == 1000
    d = tnet.conf.defaults
    assert (d.backprop_type, d.tbptt_fwd_length, d.tbptt_back_length) == \
        ("tbptt", 50, 50)
    u = tnet._updaters[0]
    assert isinstance(u, updaters.RmsProp) and u.learning_rate == 1e-2 \
        and u.rms_decay == 0.95 and tnet.layers[0].l2 == 1e-4
    _same_weights(tnet, jnet)
    _same_slots(tnet, jnet)
    x = np.eye(77, dtype=np.float32)[
        np.random.default_rng(4).integers(0, 77, (2, 20))]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5)
