"""The port's memory reports (`nn.memory`), gradient checker
(`util.gradientcheck`) and debug hooks (`util.debugging`) against the JAX
package's.

Memory: every report field, `inference_bytes` and `training_bytes` (remat
policies by name and bool, fsdp and a mesh's fsdp / model / dcn sizes)
equal exactly, for dense, convolutional and LSTM networks and the
autoencoder family. Gradient checks: on each network of a parametrised
subset of tests/test_gradient_checks.py (built by the JAX package, read by
the port from its JSON, the JAX params carried across), `check_gradients`
passes in both packages, and the port's analytic float64 gradient is
within 1e-10 of JAX's, relative to each leaf's largest magnitude (float64
sums in another order); a layer whose backward is wrong on purpose fails
the port's check. Debugging: `assert_finite`'s message equals JAX's on
the same tree, `nan_checks` raises FloatingPointError at the op that
makes a NaN and restores its state, `donation_checks` turns on autograd's
anomaly mode and shows what it catches.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import memory as jmem
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu.util import debugging as jdebug
from deeplearning4j_tpu.util import gradientcheck as jgc
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import memory as tmem
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec
from deeplearning4j_tpu_torch.util import debugging as tdebug
from deeplearning4j_tpu_torch.util import gradientcheck as tgc


def _conf(layers, input_type, updater=None, **kw):
    return (JNNC(seed=42, activation="tanh",
                 updater=updater or jupd.Sgd(learning_rate=0.1), **kw)
            .list(layers).set_input_type(input_type))


def _port_conf(jconf):
    return MultiLayerConfiguration.from_json(jconf.to_json())


# ----------------------------------------------------------------- memory
MEMORY_NETS = {
    "dense": lambda: _conf([jl.Dense(n_out=32, activation="relu"),
                            jl.Dense(n_out=16, name="hidden"),
                            jl.Output(n_out=10, loss="mcxent")],
                           jit.feed_forward(20), jupd.Adam(1e-3)),
    "conv": lambda: _conf([jl.Conv2D(kernel_size=(3, 3), n_out=4),
                           jl.BatchNorm(),
                           jl.Subsampling2D(kernel_size=(2, 2),
                                            stride=(2, 2)),
                           jl.Dense(n_out=8),
                           jl.Output(n_out=3, loss="mcxent")],
                          jit.convolutional(8, 8, 2),
                          jupd.Nesterovs(0.1)),
    "lstm": lambda: _conf([jl.LSTM(n_out=6), jl.GravesLSTM(n_out=5),
                           jl.RnnOutput(n_out=3, loss="mcxent")],
                          jit.recurrent(4, 7), jupd.RmsProp(1e-2)),
    "autoencoders": lambda: _conf(
        [jl.AutoEncoder(n_out=12), jl.RBM(n_out=10),
         jl.VariationalAutoencoder(n_out=3, encoder_layer_sizes=[8, 6],
                                   decoder_layer_sizes=[7]),
         jl.Output(n_out=4, loss="mcxent")],
        jit.feed_forward(16), jupd.AdaDelta()),
}


@pytest.mark.parametrize("net", sorted(MEMORY_NETS))
def test_memory_report_equals_jaxs(net):
    jconf = MEMORY_NETS[net]()
    want = jmem.memory_report(jconf)
    got = tmem.memory_report(_port_conf(jconf))
    assert got.to_json() == want.to_json()
    assert got.summary(16) == want.summary(16)
    for batch in (1, 32, 128):
        assert got.inference_bytes(batch) == want.inference_bytes(batch)
        assert got.inference_bytes(batch, 2) == \
            want.inference_bytes(batch, 2)
        for remat in (False, True, None, "none", "dots_saveable", "full",
                      "offload"):
            assert got.remat_activation_factor(remat) == \
                want.remat_activation_factor(remat)
            assert got.training_bytes(batch, remat=remat) == \
                want.training_bytes(batch, remat=remat)
        for fsdp in (1, 2, 4):
            assert got.training_bytes(batch, fsdp=fsdp) == \
                want.training_bytes(batch, fsdp=fsdp)
        for spec in (dict(fsdp=2, model=2), dict(dcn=2, fsdp=4),
                     dict(data=8)):
            assert got.training_bytes(
                batch, 2, "full", mesh_spec=MeshSpec(**spec), fsdp=8) == \
                want.training_bytes(batch, 2, "full",
                                    mesh_spec=JMeshSpec(**spec), fsdp=8)
            assert got.training_bytes(batch, mesh_spec=MeshSpec(**spec)) \
                == want.training_bytes(batch, mesh_spec=JMeshSpec(**spec))
    with pytest.raises(ValueError, match="unknown remat policy"):
        want.remat_activation_factor("sometimes")
    with pytest.raises(ValueError, match="unknown remat policy"):
        got.remat_activation_factor("sometimes")


def test_memory_report_counts_the_port_networks_params():
    """The report's total is the initialized port network's count, and it
    allocates nothing on a device (the params are drawn on the CPU)."""
    conf = _port_conf(MEMORY_NETS["autoencoders"]())
    report = tmem.memory_report(conf)
    net = MultiLayerNetwork(conf).init(device="cpu")
    assert report.total_params == net.num_params()
    assert report.updater_slots == 2  # AdaDelta: two slots per param
    assert tmem._UPDATER_SLOTS == jmem._UPDATER_SLOTS


# --------------------------------------------------------- gradient checks
def _class_ds(rng, n=8, f=6, c=3):
    x = rng.standard_normal((n, f)).astype(np.float64)
    return x, np.eye(c)[rng.integers(0, c, n)]


def _unit_ds(rng, n=8, f=6, c=3):
    x = rng.random((n, f)).astype(np.float64)
    return x, np.eye(c)[rng.integers(0, c, n)]


def _img_ds(rng, n=4, h=8, w=8, ch=2, c=3):
    x = rng.standard_normal((n, h, w, ch)).astype(np.float64)
    return x, np.eye(c)[rng.integers(0, c, n)]


def _seq_ds(rng, n=4, t=6, f=5, c=3):
    x = rng.standard_normal((n, t, f)).astype(np.float64)
    ids = rng.integers(0, c, n)
    y = np.zeros((n, t, c))
    y[np.arange(n), :, ids] = 1.0
    return x, y


def _masked(rng):
    x, y = _seq_ds(rng)
    mask = np.ones((4, 6))
    mask[:, 4:] = 0.0
    mask[1, 2:] = 0.0
    return x, y, mask, mask


GRAD_NETS = {
    "dense_mlp": ([jl.Dense(n_out=8, activation="tanh"),
                   jl.Dense(n_out=6, activation="sigmoid"),
                   jl.Output(n_out=3, loss="mcxent")],
                  jit.feed_forward(6), _class_ds, {}),
    "loss_mse": ([jl.Dense(n_out=5, activation="tanh"),
                  jl.Output(n_out=3, loss="mse", activation="identity")],
                 jit.feed_forward(6), _class_ds, {}),
    "loss_xent": ([jl.Dense(n_out=5, activation="tanh"),
                   jl.Output(n_out=3, loss="xent", activation="sigmoid")],
                  jit.feed_forward(6),
                  lambda rng: (lambda x, y: (x, (y + 0.1) / 1.3))(
                      *_class_ds(rng)), {}),
    "l1_l2": ([jl.Dense(n_out=8, activation="tanh"),
               jl.Output(n_out=3, loss="mcxent")],
              jit.feed_forward(6), _class_ds, dict(l1=0.01, l2=0.02)),
    "cnn": ([jl.Conv2D(kernel_size=(3, 3), n_out=3, activation="tanh"),
             jl.Subsampling2D(kernel_size=(2, 2), stride=(2, 2),
                              pooling_type="max"),
             jl.Dense(n_out=8, activation="tanh"),
             jl.Output(n_out=3, loss="mcxent")],
            jit.convolutional(8, 8, 2), _img_ds, {}),
    "batchnorm": ([jl.Dense(n_out=8, activation="identity"),
                   jl.BatchNorm(),
                   jl.Activation(activation="tanh"),
                   jl.Output(n_out=3, loss="mcxent")],
                  jit.feed_forward(6), _class_ds, {}),
    "lstm": ([jl.LSTM(n_out=4), jl.RnnOutput(n_out=3, loss="mcxent")],
             jit.recurrent(5, 6), _seq_ds, {}),
    "graves_lstm": ([jl.GravesLSTM(n_out=4),
                     jl.RnnOutput(n_out=3, loss="mcxent")],
                    jit.recurrent(5, 6), _seq_ds, {}),
    "lstm_masked": ([jl.LSTM(n_out=4), jl.RnnOutput(n_out=3, loss="mcxent")],
                    jit.recurrent(5, 6), _masked, {}),
    "autoencoder": ([jl.AutoEncoder(n_out=5, activation="tanh"),
                     jl.Output(n_out=3, loss="mcxent")],
                    jit.feed_forward(6), _unit_ds, {}),
    "rbm": ([jl.RBM(n_out=5, visible_unit="gaussian"),
             jl.Output(n_out=3, loss="mcxent")],
            jit.feed_forward(6), _class_ds, {}),
    "vae": ([jl.VariationalAutoencoder(n_out=3, encoder_layer_sizes=[5, 4],
                                       decoder_layer_sizes=[4],
                                       pzx_activation="tanh"),
             jl.Output(n_out=3, loss="mcxent")],
            jit.feed_forward(6), _class_ds, {}),
}


def _grad_pair(name):
    layers, in_type, data, kw = GRAD_NETS[name]
    jconf = (JNNC(seed=42, activation="tanh", **kw).list(
        [JLayer.from_json(l.to_json()) for l in layers])
        .set_input_type(in_type))
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(_port_conf(jconf)).init(device="cpu")
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    parts = data(np.random.default_rng(0))
    jds, tds = JDataSet(*parts), DataSet(*parts)
    return jnet, tnet, jds, tds


def _jax_analytic(jnet, ds):
    """JAX's analytic gradient as its checker computes it, keyed by the
    leaf paths joined with '/'."""
    x = jnp.asarray(ds.features, jnp.float64)
    y = jnp.asarray(ds.labels, jnp.float64)
    fm = None if ds.features_mask is None else jnp.asarray(ds.features_mask)
    lm = None if ds.labels_mask is None else jnp.asarray(ds.labels_mask)
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 jnet.params)
    with jdtypes.full_precision():
        g = jax.grad(lambda p: jnet._loss(p, jnet.state, x, y,
                                          jax.random.PRNGKey(123), fm, lm,
                                          train=False)[0])(p64)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(g)[0]}


@pytest.mark.parametrize("name", sorted(GRAD_NETS))
def test_gradient_check_passes_in_both_with_jaxs_analytic_gradient(name):
    jnet, tnet, jds, tds = _grad_pair(name)
    want = _jax_analytic(jnet, jds)
    got = tgc.analytic_gradients(tnet, tds)
    assert list(got) == list(want)  # the same leaf order
    for k, g in want.items():
        assert got[k].dtype == np.float64
        scale = max(np.abs(g).max(), 1e-30)
        assert np.abs(got[k] - g).max() <= 1e-10 * scale, k
    assert jgc.check_gradients(jnet, jds)
    assert tgc.check_gradients(tnet, tds)


def _reversed(tree):
    """The same params with every dict's keys in reverse order."""
    if isinstance(tree, dict):
        return {k: _reversed(tree[k]) for k in reversed(list(tree))}
    return tree


@pytest.mark.parametrize("name", ["cnn", "vae"])
def test_gradient_check_probes_jaxs_entries(name):
    """max_params_per_layer below a leaf's size: the same subsample of the
    same leaves (printed as the JAX checker prints its failures, with an
    error bound that every entry breaks), in JAX's sorted leaf order
    whatever order the port's dicts hold their params in."""
    jnet, tnet, jds, tds = _grad_pair(name)
    tnet.params = _reversed(tnet.params)
    assert list(tgc.analytic_gradients(tnet, tds)) == \
        list(_jax_analytic(jnet, jds))
    import contextlib
    import io

    outs = []
    for check, net, ds in ((jgc.check_gradients, jnet, jds),
                           (tgc.check_gradients, tnet, tds)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert not check(net, ds, max_rel_error=-1.0, min_abs_error=-1.0,
                             max_params_per_layer=3, seed=7, verbose=True)
        outs.append([line.split(":")[0] for line in
                     buf.getvalue().splitlines() if line.startswith("leaf")])
    assert outs[0] == outs[1]
    # the CNN: W and b of three layers; the VAE: 12 leaves and the
    # Output's 2, 3 entries each (the 3-wide biases all of theirs)
    assert len(outs[0]) == (6 if name == "cnn" else 14) * 3


def test_gradient_check_fails_a_wrong_backward(monkeypatch):
    """A Dense layer whose backward doubles its input gradient (forward
    unchanged) fails the port's check; the same network passes without
    it."""
    jnet, tnet, jds, tds = _grad_pair("dense_mlp")
    assert tgc.check_gradients(tnet, tds)

    class Doubled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return 2 * g

    layer = tnet.layers[1]
    apply = layer.apply

    def wrong(params, x, **kw):
        y, st = apply(params, x, **kw)
        return Doubled.apply(y), st

    monkeypatch.setattr(layer, "apply", wrong)
    assert not tgc.check_gradients(tnet, tds)


# -------------------------------------------------------------- debugging
def _tree(lib):
    nan = float("nan")

    def arr(v):
        return (torch.tensor(v, dtype=torch.float32) if lib == "torch"
                else np.asarray(v, np.float32))

    return {"layer_1": {"W": arr([[1.0, nan], [float("inf"), 2.0]]),
                        "b": arr([0.0])},
            "layer_0": {"W": arr([1.0, 2.0]), "b": arr([0.5])},
            "opt": [{"m": arr([1.0])}, {"m": arr([nan, nan, 1.0])}]}


@pytest.mark.parametrize("drop", [None, "layer_1"])
def test_assert_finite_message_is_jaxs(drop):
    """The first non-finite leaf in JAX's order (sorted keys, list
    indices) and its count, in the same words; a finite tree passes."""
    jt, tt = _tree("numpy"), _tree("torch")
    if drop:
        jt.pop(drop), tt.pop(drop)
    with pytest.raises(ValueError) as jerr:
        jdebug.assert_finite(jax.tree_util.tree_map(jnp.asarray, jt),
                             "params after fit")
    with pytest.raises(ValueError) as terr:
        tdebug.assert_finite(tt, "params after fit")
    assert str(terr.value) == str(jerr.value)
    assert ("'layer_1/W' (2/4" if drop is None else "'opt/1/m' (2/3") in \
        str(terr.value)
    tdebug.assert_finite({"a": [torch.ones(2), np.zeros(3)]})
    tdebug.assert_finite(torch.ones(3), "a tensor")


def test_nan_checks_raise_at_the_op_and_restore_the_state():
    """Inside nan_checks the op that makes a NaN raises FloatingPointError
    naming it, in a forward and in a backward; nan_checks(False) inside
    turns it off for its block; after the block NaNs pass again."""
    x = torch.tensor([4.0, -1.0])
    assert torch.isnan(torch.sqrt(x)).any()
    with tdebug.nan_checks():
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(x)
        with tdebug.nan_checks(False):
            assert torch.isnan(torch.sqrt(x)).any()
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(x)
        torch.empty(1 << 12)  # uninitialized memory is not checked
        w = torch.zeros(2, requires_grad=True)
        y = (torch.sqrt(w) * 0).sum()  # finite forward, 0 / 0 backward
        with pytest.raises(FloatingPointError):
            y.backward()
    assert torch.isnan(torch.sqrt(x)).any()
    assert not tdebug._nan_checks_on


def test_nan_checks_raise_on_a_nan_batch_through_a_network():
    """A NaN batch through an AutoEncoder -> Output network raises at the
    first product, in fit and in pretrain; a finite batch trains."""
    jnet, tnet, jds, tds = _grad_pair("autoencoder")
    x, y = np.array(tds.features, np.float32), np.array(tds.labels,
                                                         np.float32)
    with tdebug.nan_checks():
        tnet.fit(x, y)
        x[0, 0] = np.nan
        with pytest.raises(FloatingPointError, match="aten.mm"):
            tnet.fit(x, y)
        with pytest.raises(FloatingPointError):
            tnet.pretrain(DataSet(x, y))


def test_donation_checks_turn_on_autograds_anomaly_mode():
    """What the port's donation_checks catch: a tensor saved for the
    backward and overwritten in place (refused always; inside the block
    the refusal also names the forward op that saved it), and a backward
    that returns NaN (refused only inside the block). The anomaly setting
    comes back after."""
    assert not torch.is_anomaly_enabled()

    def overwritten():
        a = torch.ones(3, requires_grad=True)
        b = a.sigmoid()
        b.mul_(2)  # sigmoid's backward reads its output
        b.sum().backward()

    def nan_backward():
        w = torch.zeros(2, requires_grad=True)
        (torch.sqrt(w) * 0).sum().backward()  # SqrtBackward0 gives 0 / 0
        return w.grad

    with pytest.raises(RuntimeError, match="inplace operation"):
        overwritten()
    assert torch.isnan(nan_backward()).any()
    with tdebug.donation_checks():
        assert torch.is_anomaly_enabled()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with pytest.raises(RuntimeError, match="inplace operation"):
                overwritten()
        assert any("SigmoidBackward0" in str(w.message) for w in seen)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # anomaly mode's traceback
            with pytest.raises(RuntimeError, match="returned nan"):
                nan_backward()
        with tdebug.donation_checks(False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
    with jdebug.donation_checks():  # the JAX switch it stands for
        assert jax.config.jax_enable_checks
