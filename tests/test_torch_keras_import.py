"""The port's Keras importer against the JAX package's, on the same files.

Each case writes its .h5 with h5py in the Keras container layout (the
writers of tests/test_keras_import.py), imports it with both packages (the
port on the CPU, reading through its own HDF5 module) and holds the port
to the JAX network: the same parameters and running statistics in the
interchange layout, bit for bit, and every layer's activation within 1e-5
of its largest magnitude (float32 on both sides, sums in another order).
InceptionV3 is compared at every vertex within 1e-4 of each activation's
largest magnitude: 313 activations deep, the float32 differences of the two
CPU backends' convolutions grow through the network (2e-6 measured at
75x75).
"""
import json

import h5py
import numpy as np
import pytest
import torch

import test_keras_import as jk
from deeplearning4j_tpu.modelimport import (
    import_keras_model_and_weights as jax_import,
)
from deeplearning4j_tpu.modelimport import (
    import_keras_sequential_model_and_weights as jax_import_seq,
)
from deeplearning4j_tpu.modelimport import trainedmodels as jtm
from deeplearning4j_tpu_torch.modelimport import (
    KerasModelImport,
    import_keras_model_and_weights,
    import_keras_sequential_model_and_weights,
)
from deeplearning4j_tpu_torch.modelimport import keras as tkeras
from deeplearning4j_tpu_torch.modelimport import trainedmodels as ttm
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork


def _same_params(tnet, jnet):
    """Params (interchange layout) and running state equal bit for bit."""
    tt, jt = tnet.get_param_table(), jnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)
    for k, st in jnet.state.items():
        for s, v in st.items():
            np.testing.assert_array_equal(tnet.state[k][s].numpy(),
                                          np.asarray(v), err_msg=f"{k}/{s}")


def _worst_activation(tnet, jnet, *xs):
    """The largest relative difference over every activation."""
    got, want = tnet.feed_forward(*xs), jnet.feed_forward(*xs)
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        worst = max(worst, float(np.abs(g - w).max()
                                 / max(np.abs(w).max(), 1e-30)))
    return worst


def _both(path, seq=True):
    if seq:
        return (import_keras_sequential_model_and_weights(path, device="cpu"),
                jax_import_seq(path))
    return import_keras_model_and_weights(path, device="cpu"), \
        jax_import(path)


@pytest.mark.parametrize("writer,in_shape", [
    (jk._seq_model_h5, (4, 20)),
    (jk._cnn_model_h5, (2, 8, 8, 2)),
    (jk._lstm_model_h5, (2, 5, 3)),
], ids=["dense-dropout", "conv-bn-pool-flatten", "lstm"])
def test_sequential_files_match_jax(tmp_path, rng, writer, in_shape):
    p = tmp_path / "m.h5"
    writer(p, rng)
    tnet, jnet = _both(p)
    assert isinstance(tnet, MultiLayerNetwork)
    assert [type(l).__name__ for l in tnet.layers] == \
        [type(l).__name__ for l in jnet.layers]
    _same_params(tnet, jnet)
    x = rng.standard_normal(in_shape).astype(np.float32)
    assert _worst_activation(tnet, jnet, x) <= 1e-5


def test_functional_graph_matches_jax(tmp_path, rng):
    p = tmp_path / "func.h5"
    jk._functional_model_h5(p, rng)
    tnet, jnet = _both(p, seq=False)
    assert isinstance(tnet, ComputationGraph)
    assert type(tnet.layer("out")).__name__ == "Output"
    _same_params(tnet, jnet)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    assert _worst_activation(tnet, jnet, x) <= 1e-5


def _model_h5(path, layers, weights):
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(
            {"class_name": "Sequential", "config": {"layers": layers}})
        for name, ws in weights.items():
            jk._write_weights(f, name, ws)


def test_batchnorm_scale_false_and_center_false_match_jax(tmp_path, rng):
    """scale=False / center=False shorten the h5 weight list: beta (or
    gamma) and the moving statistics must land in their own slots."""
    n = 4
    for scale, center in ((False, True), (True, False)):
        bn_w = []
        gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
        beta = rng.standard_normal(n).astype(np.float32)
        if scale:
            bn_w.append(("gamma:0", gamma))
        if center:
            bn_w.append(("beta:0", beta))
        bn_w += [("moving_mean:0", rng.standard_normal(n).astype(np.float32)),
                 ("moving_variance:0",
                  rng.uniform(0.5, 2, n).astype(np.float32))]
        p = tmp_path / f"bn_{scale}_{center}.h5"
        _model_h5(p, [
            {"class_name": "Dense",
             "config": {"name": "d1", "units": n, "activation": "linear",
                        "batch_input_shape": [None, 3]}},
            {"class_name": "BatchNormalization",
             "config": {"name": "bn", "scale": scale, "center": center,
                        "momentum": 0.9, "epsilon": 1e-3}},
            {"class_name": "Dense",
             "config": {"name": "fc", "units": 2, "activation": "softmax"}},
        ], {"d1": [("kernel:0", rng.standard_normal((3, n)).astype(
            np.float32)), ("bias:0", rng.standard_normal(n).astype(
                np.float32))],
            "bn": bn_w,
            "fc": [("kernel:0", rng.standard_normal((n, 2)).astype(
                np.float32)), ("bias:0", np.zeros(2, np.float32))]})
        tnet, jnet = _both(p)
        _same_params(tnet, jnet)
        np.testing.assert_array_equal(tnet.state["layer_1"]["var"].numpy(),
                                      bn_w[-1][1])
        x = rng.standard_normal((3, 3)).astype(np.float32)
        assert _worst_activation(tnet, jnet, x) <= 1e-5


def test_weight_order_without_weight_names_matches_jax(tmp_path, rng):
    """A group without weight_names (as TF-scoped files have): the walk
    is alphabetical (bias:0 first), the canonical order puts the kernel
    first."""
    w = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    p = tmp_path / "noattr.h5"
    with h5py.File(p, "w") as f:
        f.attrs["model_config"] = json.dumps({
            "class_name": "Sequential", "config": {"layers": [
                {"class_name": "Dense",
                 "config": {"name": "d1", "units": 3, "activation": "softmax",
                            "batch_input_shape": [None, 5]}}]}})
        g = f.require_group("model_weights").require_group("d1")
        g.create_dataset("bias:0", data=b)
        g.create_dataset("kernel:0", data=w)
    tnet, jnet = _both(p)
    np.testing.assert_array_equal(tnet.get_param_table()["layer_0/W"], w)
    np.testing.assert_array_equal(tnet.get_param_table()["layer_0/b"], b)
    _same_params(tnet, jnet)


def test_leaky_relu_alpha_and_reshape_match_jax(tmp_path, rng):
    """LeakyReLU keeps Keras's slope; Reshape becomes a ReshapePreprocessor
    on the next layer; Flatten needs none."""
    p = tmp_path / "leaky.h5"
    _model_h5(p, [
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 12, "activation": "linear",
                    "batch_input_shape": [None, 6]}},
        {"class_name": "LeakyReLU", "config": {"name": "lr", "alpha": 0.3}},
        {"class_name": "Reshape",
         "config": {"name": "rs", "target_shape": [2, 2, 3]}},
        {"class_name": "Conv2D",
         "config": {"name": "c", "filters": 2, "kernel_size": [2, 1],
                    "padding": "same", "activation": "tanh"}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense",
         "config": {"name": "fc", "units": 4, "activation": "softmax"}},
    ], {"d1": [("kernel:0", rng.standard_normal((6, 12)).astype(np.float32)),
               ("bias:0", rng.standard_normal(12).astype(np.float32))],
        "c": [("kernel:0", rng.standard_normal((2, 1, 3, 2)).astype(
            np.float32)), ("bias:0", rng.standard_normal(2).astype(
                np.float32))],
        "fc": [("kernel:0", rng.standard_normal((8, 4)).astype(np.float32)),
               ("bias:0", np.zeros(4, np.float32))]})
    tnet, jnet = _both(p)
    assert tnet.layers[1].activation == "leakyrelu:0.3"
    assert type(tnet.conf.input_preprocessors[2]).__name__ == \
        "ReshapePreprocessor"
    _same_params(tnet, jnet)
    x = -np.abs(rng.standard_normal((3, 6))).astype(np.float32)
    assert _worst_activation(tnet, jnet, x) <= 1e-5


def test_keras1_twelve_array_lstm_matches_jax_and_keras2(tmp_path, rng):
    """Keras-1 LSTMs store 12 per-gate arrays (W, U, b per gate in the
    order i, c, f, o); they fuse into the [*, 4n] (i, f, g, o) layout and
    give the keras-2 fused file's outputs."""
    n_in, n = 5, 4
    blocks = {g: (rng.standard_normal((n_in, n)).astype(np.float32),
                  rng.standard_normal((n, n)).astype(np.float32),
                  rng.standard_normal(n).astype(np.float32)) for g in "icfo"}
    layers = [{"class_name": "LSTM",
               "config": {"name": "l", "units": n, "activation": "tanh",
                          "recurrent_activation": "sigmoid",
                          "return_sequences": True,
                          "batch_input_shape": [None, 6, n_in]}}]
    fused = [("kernel:0", np.concatenate([blocks[g][0] for g in "ifco"], -1)),
             ("recurrent_kernel:0",
              np.concatenate([blocks[g][1] for g in "ifco"], -1)),
             ("bias:0", np.concatenate([blocks[g][2] for g in "ifco"]))]
    twelve = [(f"{k}_{g}:0", blocks[g][i]) for g in "icfo"
              for i, k in enumerate("WUb")]
    p2, p1 = tmp_path / "k2.h5", tmp_path / "k1.h5"
    _model_h5(p2, layers, {"l": fused})
    _model_h5(p1, layers, {"l": twelve})
    t1, j1 = _both(p1)
    t2 = import_keras_sequential_model_and_weights(p2, device="cpu")
    _same_params(t1, j1)
    x = rng.standard_normal((2, 6, n_in)).astype(np.float32)
    assert _worst_activation(t1, j1, x) <= 1e-5
    np.testing.assert_allclose(t1.output(x).numpy(), t2.output(x).numpy(),
                               rtol=0, atol=1e-6)


def test_keras1_config_and_translator_rules_match_jax():
    """Keras-1 field names, TimeDistributed, the atrous 2D form and the
    LSTM's inner activation translate to the same layer JSON as in the JAX
    package."""
    from deeplearning4j_tpu.modelimport.keras import KerasLayerTranslator as J

    cases = [
        ("TimeDistributedDense", {"name": "d", "output_dim": 8,
                                  "activation": "tanh"}),
        ("AtrousConvolution2D", {"name": "c", "nb_filter": 4, "nb_row": 3,
                                 "nb_col": 5, "atrous_rate": [2, 2],
                                 "border_mode": "same",
                                 "subsample": [1, 1]}),
        ("LSTM", {"name": "l", "output_dim": 8, "activation": "tanh",
                  "inner_activation": "hard_sigmoid"}),
        ("TimeDistributed", {"name": "td", "layer": {
            "class_name": "Dense", "config": {"units": 3,
                                              "activation": "relu"}}}),
        ("Convolution2D", {"name": "c2", "nb_filter": 2, "nb_row": 1,
                           "nb_col": 1, "border_mode": "valid"}),
        ("Dropout", {"name": "do", "rate": 0.25}),
        ("GlobalAveragePooling1D", {"name": "gap"}),
        ("Embedding", {"name": "e", "input_dim": 10, "output_dim": 4}),
    ]
    t = tkeras.KerasLayerTranslator()
    for cls, cfg in cases:
        assert t.translate(cls, cfg).to_json() == \
            J().translate(cls, cfg).to_json(), cls
    for cls, cfg in (("Add", {}), ("Concatenate", {"axis": 3}),
                     ("Merge", {"mode": "ave"}), ("Maximum", {})):
        assert t.translate(cls, cfg).to_json() == \
            J().translate(cls, cfg).to_json(), cls
    with pytest.raises(ValueError, match="TimeDistributed"):
        t.translate("TimeDistributed",
                    {"name": "x", "layer": {"class_name": "Conv2D",
                                            "config": {}}})


def test_unknown_keras_class_raises_value_error(tmp_path):
    p = tmp_path / "bad.h5"
    _model_h5(p, [{"class_name": "Lambda",
                   "config": {"name": "l", "batch_input_shape": [None, 4]}}],
              {})
    with pytest.raises(ValueError, match="Unsupported Keras layer"):
        import_keras_sequential_model_and_weights(p, device="cpu")


# the Keras classes whose port layers came with ROADMAP A.8, each with
# the layer the JAX importer translates it into
A8_CLASSES = {
    "AtrousConvolution1D": "Conv1D", "AveragePooling1D": "Subsampling1D",
    "Conv1D": "Conv1D", "Conv2DTranspose": "Deconv2D",
    "Convolution1D": "Conv1D", "Deconvolution2D": "Deconv2D",
    "MaxPooling1D": "Subsampling1D", "SeparableConv2D": "SeparableConv2D",
    "UpSampling1D": "Upsampling1D", "UpSampling2D": "Upsampling2D",
    "ZeroPadding1D": "ZeroPadding1D", "ZeroPadding2D": "ZeroPadding2D"}


@pytest.mark.parametrize("cls", sorted(A8_CLASSES))
def test_unported_keras_layers_raise_not_implemented(cls):
    """Each of the twelve Keras classes the port once refused (until
    ROADMAP A.8) now translates into the layer the JAX importer gives,
    with the same JSON."""
    from deeplearning4j_tpu.modelimport.keras import KerasLayerTranslator as J

    cfg = {"name": "x", "filters": 2, "kernel_size": 3, "units": 2,
           "pool_size": 2, "padding": 1, "size": 2, "atrous_rate": 2}
    want = J().translate(cls, dict(cfg))
    got = tkeras.KerasLayerTranslator().translate(cls, dict(cfg))
    assert type(got).__name__ == type(want).__name__ == A8_CLASSES[cls]
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())


@pytest.mark.parametrize("return_sequences", [True, False])
def test_simple_rnn_written_by_the_port_imports_as_jax(tmp_path, rng,
                                                       return_sequences):
    """A Keras SimpleRNN(6, tanh) over [7, 5] and a softmax Dense, written
    by the port's HDF5 writer: both packages import the same layers and
    params and compute the same activations. Neither importer reads
    return_sequences, so both give [b, 7, 2] either way."""
    from deeplearning4j_tpu_torch.modelimport import hdf5

    layers = [{"class_name": "SimpleRNN",
               "config": {"name": "rnn", "units": 6, "activation": "tanh",
                          "return_sequences": return_sequences,
                          "batch_input_shape": [None, 7, 5]}},
              {"class_name": "Dense",
               "config": {"name": "out", "units": 2,
                          "activation": "softmax"}}]
    weights = {"rnn": [("kernel:0", rng.standard_normal((5, 6))),
                       ("recurrent_kernel:0", rng.standard_normal((6, 6))),
                       ("bias:0", rng.standard_normal(6))],
               "out": [("kernel:0", rng.standard_normal((6, 2))),
                       ("bias:0", rng.standard_normal(2))]}
    p = tmp_path / "rnn.h5"
    with hdf5.File(p, "w") as f:
        f.attrs["model_config"] = json.dumps(
            {"class_name": "Sequential", "config": {"layers": layers}})
        for name, ws in weights.items():
            jk._write_weights(f, name, [(n, a.astype(np.float32) * 0.5)
                                        for n, a in ws])
    tnet, jnet = _both(p)
    assert [type(l).__name__ for l in tnet.layers] == \
        [type(l).__name__ for l in jnet.layers] == ["SimpleRnn", "Output"]
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _same_params(tnet, jnet)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    assert tnet.output(x).shape == (3, 7, 2)
    assert _worst_activation(tnet, jnet, x) <= 1e-5


def test_unported_layer_in_a_file_raises_not_implemented(tmp_path, rng):
    """SeparableConv2D (test_keras_import's layout case), once refused,
    imports as the JAX package imports it: the depthwise kernel [3, 3, 2,
    2] reshaped to the grouped conv's [3, 3, 1, 4], the same params and
    activations within 1e-5."""
    p = tmp_path / "sep.h5"
    _model_h5(p, [
        {"class_name": "SeparableConv2D",
         "config": {"name": "sep", "filters": 6, "kernel_size": [3, 3],
                    "padding": "same", "depth_multiplier": 2,
                    "use_bias": False, "batch_input_shape": [None, 6, 6, 2]}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense",
         "config": {"name": "fc", "units": 3, "activation": "softmax"}}],
        {"sep": [("depthwise_kernel:0",
                  rng.standard_normal((3, 3, 2, 2)).astype(np.float32)),
                 ("pointwise_kernel:0",
                  rng.standard_normal((1, 1, 4, 6)).astype(np.float32))],
         "fc": [("kernel:0",
                 rng.standard_normal((216, 3)).astype(np.float32) * 0.1),
                ("bias:0", rng.standard_normal(3).astype(np.float32))]})
    tnet, jnet = _both(p)
    assert [type(l).__name__ for l in tnet.layers] == \
        [type(l).__name__ for l in jnet.layers]
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _same_params(tnet, jnet)
    x = rng.standard_normal((3, 6, 6, 2)).astype(np.float32)
    assert _worst_activation(tnet, jnet, x) <= 1e-5


def _square_conv_h5(path, rng):
    """A 3x3 conv whose kernel has cin == cout, so its HWIO array and the
    port's OIHW tensor hold the same number of values in the same shape
    pattern; a wrong copy would not show in the shapes."""
    _model_h5(path, [
        {"class_name": "Conv2D",
         "config": {"name": "c", "filters": 4, "kernel_size": [3, 3],
                    "padding": "same", "activation": "linear",
                    "use_bias": False, "batch_input_shape": [None, 5, 5, 4]}},
        {"class_name": "GlobalAveragePooling2D", "config": {"name": "g"}},
        {"class_name": "Dense",
         "config": {"name": "fc", "units": 2, "activation": "softmax"}}],
        {"c": [("kernel:0", rng.standard_normal((3, 3, 4, 4)).astype(
            np.float32))],
         "fc": [("kernel:0", rng.standard_normal((4, 2)).astype(np.float32)),
                ("bias:0", np.zeros(2, np.float32))]})


def test_a_kernel_copied_to_the_wrong_layout_fails_the_comparison(
        tmp_path, rng, monkeypatch):
    """The comparison above catches a copy-in that skips the layer's
    interchange hook and reshapes the HWIO array onto the OIHW tensor."""
    p = tmp_path / "sq.h5"
    _square_conv_h5(p, rng)
    x = rng.standard_normal((2, 5, 5, 4)).astype(np.float32)
    tnet, jnet = _both(p)
    assert _worst_activation(tnet, jnet, x) <= 1e-5

    def raw_copy(layer, params, device=None):
        out = {}
        for k, arr in params.items():
            t = torch.from_numpy(np.array(arr, np.float32))
            if k == "W" and t.dim() == 4:  # HWIO values, OIHW shape
                t = t.reshape(t.shape[3], t.shape[2], t.shape[0],
                              t.shape[1]).contiguous(
                    memory_format=torch.channels_last)
            out[k] = t
        return out

    monkeypatch.setattr(tkeras.interop, "layer_params_from_jax", raw_copy)
    bad = import_keras_sequential_model_and_weights(p, device="cpu")
    assert _worst_activation(bad, jnet, x) > 1e-2


def test_a_keras_array_of_the_wrong_shape_raises(tmp_path, rng):
    p = tmp_path / "wrong.h5"
    _model_h5(p, [
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 3, "activation": "softmax",
                    "batch_input_shape": [None, 5]}}],
        {"d1": [("kernel:0", rng.standard_normal((3, 5)).astype(np.float32)),
                ("bias:0", np.zeros(3, np.float32))]})
    with pytest.raises(ValueError, match=r"'W' has shape \(3, 5\)"):
        import_keras_sequential_model_and_weights(p, device="cpu")


# ---- InceptionV3 (BASELINE config #4) ----

def test_inception_v3_config_and_writer_equal_jax(tmp_path):
    """The same config dict for the same arguments, and the same datasets,
    bit for bit, and attributes from the port's writer (read by h5py)."""
    for args in (((299, 299, 3), 1000), ((75, 75, 3), 10)):
        assert ttm.inception_v3(*args) == jtm.inception_v3(*args)
    jp, tp = tmp_path / "j.h5", tmp_path / "t.h5"
    cfg = jtm.write_inception_v3_h5(str(jp), (75, 75, 3), 10, seed=4)
    assert ttm.write_inception_v3_h5(str(tp), (75, 75, 3), 10, seed=4) == cfg
    with h5py.File(jp, "r") as a, h5py.File(tp, "r") as b:
        assert dict(a.attrs) == dict(b.attrs)
        names = []
        a.visititems(lambda n, o: names.append(n))
        seen = []
        b.visititems(lambda n, o: seen.append(n))
        assert names == seen and len(names) == 1 + 189 + 472
        for n in names:
            if isinstance(a[n], h5py.Dataset):
                assert a[n].dtype == b[n].dtype
                np.testing.assert_array_equal(a[n][()], b[n][()])
            else:
                assert sorted(a[n].attrs) == sorted(b[n].attrs)
                for k in a[n].attrs:
                    np.testing.assert_array_equal(a[n].attrs[k],
                                                  b[n].attrs[k])
    x = np.arange(12, dtype=np.float32).reshape(1, 2, 2, 3)
    np.testing.assert_array_equal(ttm.inception_preprocess(x),
                                  jtm.inception_preprocess(x))
    np.testing.assert_array_equal(ttm.vgg16_preprocess(x),
                                  jtm.vgg16_preprocess(x))


def _nontrivial_batchnorm(path, seed):
    """Rewrite every BatchNormalization's gamma, beta, moving mean and
    moving variance with seeded values far from the writer's 1, 0, 0, 1,
    so a swapped mean/var or gamma/beta changes the output."""
    rng = np.random.default_rng(seed)
    with h5py.File(path, "r+") as f:
        for lname, g in f["model_weights"].items():
            if not lname.startswith("batch_normalization"):
                continue
            n = g["gamma:0"].shape
            g["gamma:0"][...] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            g["beta:0"][...] = rng.normal(0, 0.5, n).astype(np.float32)
            g["moving_mean:0"][...] = rng.normal(0, 0.5, n).astype(np.float32)
            g["moving_variance:0"][...] = rng.uniform(0.5, 2.0, n).astype(
                np.float32)


def test_inception_v3_end_to_end_matches_jax_at_every_vertex(tmp_path):
    """BASELINE config #4 at 299x299, batch 2, 100 classes: the file the
    JAX writer wrote, with non-trivial BatchNorm values, imported by both
    packages; 94 bias-free Conv2D, 94 BatchNorm, 15 MergeVertex, every
    parameter and statistic bit for bit, every vertex within 1e-4."""
    path = str(tmp_path / "iv3.h5")
    jtm.write_inception_v3_h5(path, classes=100, seed=1)
    _nontrivial_batchnorm(path, seed=2)
    tnet = KerasModelImport.importKerasModelAndWeights(path, device="cpu")
    jnet = jax_import(path)
    assert isinstance(tnet, ComputationGraph)
    kinds = [type(tnet.conf.vertices[n]).__name__ if tnet.layer(n) is None
             else type(tnet.layer(n)).__name__ for n in tnet.topo]
    assert kinds.count("Conv2D") == 94 and kinds.count("BatchNorm") == 94
    assert kinds.count("MergeVertex") == 15
    assert all(not tnet.layer(n).has_bias for n in tnet.topo
               if kinds[tnet.topo.index(n)] == "Conv2D")
    assert tnet.num_params() == jnet.num_params() > 21e6
    _same_params(tnet, jnet)
    x = jtm.inception_preprocess(np.random.default_rng(0).integers(
        0, 256, (2, 299, 299, 3))).astype(np.float32)
    assert _worst_activation(tnet, jnet, x) <= 1e-4
    out = tnet.output(x).numpy()
    assert out.shape == (2, 100)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


def test_inception_v3_written_by_the_port_imports_in_both_packages(tmp_path):
    """The port's own writer's file is read by h5py and by the JAX
    importer. Its model_config (about 66 KB whatever the input size) is
    larger than an object-header message may be, so it is held as a
    variable-length string, as h5py writes a str."""
    path = str(tmp_path / "port.h5")
    ttm.write_inception_v3_h5(path, (75, 75, 3), classes=10, seed=6)
    with h5py.File(path, "r") as f:
        text = f.attrs["model_config"]
    assert len(text) > 64 * 1024
    assert json.loads(text) == jtm.inception_v3((75, 75, 3), 10)[0]
    tnet = import_keras_model_and_weights(path, device="cpu")
    jnet = jax_import(path)
    _same_params(tnet, jnet)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 75, 75, 3)).astype(
        np.float32)
    assert _worst_activation(tnet, jnet, x) <= 1e-4


def test_the_importer_runs_on_the_card_unless_asked_for_the_cpu(
        tmp_path, rng, monkeypatch):
    p = tmp_path / "func.h5"
    jk._functional_model_h5(p, rng)
    cfg = tmp_path / "cfg.json"
    with h5py.File(p, "r") as f:
        cfg.write_text(f.attrs["model_config"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: import_keras_model_and_weights(p),
                 lambda: KerasModelImport.importKerasModelConfiguration(cfg),
                 lambda: tkeras.import_keras_sequential_configuration(
                     jk_seq_json(tmp_path, rng))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert import_keras_model_and_weights(p, device="cpu").device == \
        torch.device("cpu")


def jk_seq_json(tmp_path, rng):
    p = tmp_path / "seq.h5"
    jk._seq_model_h5(p, rng)
    out = tmp_path / "seq.json"
    with h5py.File(p, "r") as f:
        out.write_text(f.attrs["model_config"])
    return out


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_a8_keras_files_import_as_jax(tmp_path, rng, kind):
    """chip_smoke.py keras-a8's files, written by the port's HDF5 writer
    (Conv2D -> ZeroPadding2D -> SeparableConv2D -> UpSampling2D ->
    Conv2DTranspose; Conv1D -> MaxPooling1D -> UpSampling1D ->
    ZeroPadding1D): both packages import the same layers, JSON and params
    (Conv2DTranspose's kernel turned to HWIO, Conv1D's given its unit
    axis, the depthwise kernel regrouped) and compute the same
    activations within 1e-5."""
    import chip_smoke

    p = tmp_path / f"a8_{kind}.h5"
    shape = chip_smoke.write_keras_a8_h5(np, str(p), kind)
    tnet, jnet = _both(p)
    assert [type(l).__name__ for l in tnet.layers] == \
        [type(l).__name__ for l in jnet.layers]
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _same_params(tnet, jnet)
    x = rng.standard_normal((3, *shape)).astype(np.float32)
    assert _worst_activation(tnet, jnet, x) <= 1e-5
