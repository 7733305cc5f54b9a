"""The autoencoder family in the port (AutoEncoder, RBM,
VariationalAutoencoder) and layerwise pretraining
(`MultiLayerNetwork.pretrain` / `pretrain_layer`), against the JAX package.

Each layer is built by the JAX package and read by the port from its JSON;
the JAX layer's weights (every 1-D param drawn nonzero) are carried across
with `interop.layer_params_from_jax`, both take the same numpy input made
from a seed, and the port's draws replay JAX's keys (`torch_keys.JaxKeys`:
the corruption mask, the Gibbs chain's hidden and visible samples, the
VAE's normals). Tolerances: losses 1e-5 relative; the loss's gradient with
respect to every param, 1e-5 of its largest magnitude (float32 sums in
another order); `reconstruction_probability` 1e-5 relative. Networks:
scores 1e-5 relative, params 1e-5 absolute after every pretrain batch
count compared and after the fine-tuning fit step.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.models import serialization as jser
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork, restore_model
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    RBM,
    AutoEncoder,
    VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer

from torch_keys import JaxKeys

N_IN = 7


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _x(kind, n=9, f=N_IN, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return (rng.random((n, f)) < 0.4).astype(np.float32)
    if kind == "unit":
        return rng.random((n, f)).astype(np.float32)
    return rng.standard_normal((n, f)).astype(np.float32)


def _pair(jlayer, seed=3):
    """(port layer, numpy params): the port layer from the JAX layer's
    JSON, the JAX layer's params with every 1-D param drawn nonzero."""
    tlayer = Layer.from_json(json.loads(json.dumps(jlayer.to_json())))
    assert tlayer.to_json() == jlayer.to_json()
    assert JLayer.from_json(tlayer.to_json()).to_json() == jlayer.to_json()
    assert type(tlayer).__name__ == type(jlayer).__name__
    rng = np.random.default_rng(seed)
    params = {}
    for k, v in jlayer.init_params(jax.random.PRNGKey(seed),
                                   jit.feed_forward(N_IN)).items():
        v = np.asarray(v)
        params[k] = ((rng.standard_normal(v.shape) * 0.3).astype(np.float32)
                     if v.ndim == 1 else v)
    return tlayer, params


def _loss_and_grads(jlayer, x, key, fn="pretrain_loss", **kw):
    """(JAX, port) pairs of (loss, {param: gradient}) of
    `jlayer.<fn>(params, x, key)` summed, the port's draws replaying
    `key` (None: no draws)."""
    tlayer, params = _pair(jlayer)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jloss(p):
        return jnp.sum(getattr(jlayer, fn)(p, jnp.asarray(x), key, **kw))

    jl_, jg = jax.value_and_grad(jloss)(jp)
    tp = {k: v.requires_grad_(True) for k, v in
          interop.layer_params_from_jax(tlayer, params).items()}
    tl_ = getattr(tlayer, fn)(tp, torch.from_numpy(x),
                              None if key is None else JaxKeys(key), **kw)
    tl_.sum().backward()
    tg = {k: v.grad.numpy() if v.grad is not None else np.zeros(v.shape)
          for k, v in tp.items()}
    return ((float(jl_), {k: np.asarray(v) for k, v in jg.items()}),
            (float(tl_.sum().detach()), tg))


def _assert_loss_matches(jlayer, x, key, **kw):
    (jl_, jg), (tl_, tg) = _loss_and_grads(jlayer, x, key, **kw)
    assert abs(tl_ - jl_) <= 1e-5 * abs(jl_), (tl_, jl_)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert _rel(tg[k], jg[k]) <= 1e-5, k
    return jl_


def _apply_matches(jlayer, x):
    tlayer, params = _pair(jlayer)
    want = np.asarray(jlayer.apply({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(x), state={}, train=False,
                                   rng=None)[0])
    got, _ = tlayer.apply(interop.layer_params_from_jax(tlayer, params),
                          torch.from_numpy(x), state={}, train=False)
    assert _rel(got.numpy(), want) <= 1e-6


# ------------------------------------------------------------ AutoEncoder
@pytest.mark.parametrize("corruption", [0.0, 0.3])
@pytest.mark.parametrize("draws", [True, False])
def test_autoencoder_matches_jax(corruption, draws):
    """apply (the encode), and pretrain_loss with its gradient: with draws
    the input is corrupted by JAX's keep mask (bernoulli(1 - level)),
    without them not at all."""
    layer = jl.AutoEncoder(n_out=5, corruption_level=corruption,
                           activation="sigmoid")
    x = _x("unit")
    _apply_matches(layer, x)
    key = jax.random.PRNGKey(11) if draws else None
    loss = _assert_loss_matches(layer, x, key)
    clean = _assert_loss_matches(layer, x, None)
    if draws and corruption:
        assert loss != clean  # the corruption changed the input
    else:
        assert loss == clean


def test_autoencoder_corruption_mask_is_the_keys():
    """The port's corruption mask is JAX's bernoulli(key, 0.7, x.shape),
    zeroes where it is False, and its share of zeros near the level."""
    layer = AutoEncoder(n_out=4, corruption_level=0.3)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.bernoulli(key, 0.7, (64, 32)))
    seen = {}

    class Spy(JaxKeys):
        def bernoulli(self, p, shape):
            seen["mask"] = super().bernoulli(p, shape)
            return seen["mask"]

    x = torch.ones(64, 32)
    params = {"W": torch.zeros(32, 4), "b": torch.zeros(4),
              "vb": torch.zeros(32)}
    layer.pretrain_loss(params, x, Spy(key))
    assert np.array_equal(seen["mask"].numpy(), want)
    assert abs(1 - want.mean() - 0.3) < 0.05


# -------------------------------------------------------------------- RBM
@pytest.mark.parametrize("cd_k", [1, 2])
@pytest.mark.parametrize("visible", ["binary", "gaussian"])
@pytest.mark.parametrize("draws", [True, False])
def test_rbm_cd_loss_matches_jax(cd_k, visible, draws):
    """The CD-k surrogate mean F(x) - mean F(v_k) and its gradient (the
    CD-k gradient): binary or gaussian visible units, the Gibbs chain's
    samples from JAX's keys, or mean-field without draws."""
    layer = jl.RBM(n_out=5, visible_unit=visible, cd_k=cd_k)
    x = _x("binary" if visible == "binary" else "normal")
    _apply_matches(layer, x)
    _assert_loss_matches(layer, x,
                         jax.random.PRNGKey(13) if draws else None)


@pytest.mark.parametrize("visible", ["binary", "gaussian"])
def test_rbm_free_energy_and_gibbs_chain_match_jax(visible):
    """free_energy per row and the chain's last visible probabilities
    (means) after 3 sweeps from JAX's keys."""
    layer = jl.RBM(n_out=5, visible_unit=visible, cd_k=3)
    tlayer, params = _pair(layer)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = interop.layer_params_from_jax(tlayer, params)
    x = _x("binary" if visible == "binary" else "normal")
    assert _rel(tlayer.free_energy(tp, torch.from_numpy(x)).numpy(),
                layer.free_energy(jp, jnp.asarray(x))) <= 1e-6
    key = jax.random.PRNGKey(17)
    want = layer.gibbs_chain(jp, jnp.asarray(x), key)
    got = tlayer.gibbs_chain(tp, torch.from_numpy(x), JaxKeys(key))
    assert _rel(got.numpy(), want) <= 1e-6


def test_rbm_reconstruction_objective_is_the_autoencoders():
    """objective='reconstruction' takes the AutoEncoder's corrupted
    reconstruction loss, in both packages."""
    layer = jl.RBM(n_out=5, objective="reconstruction", corruption_level=0.2)
    _assert_loss_matches(layer, _x("unit"), jax.random.PRNGKey(19))


def test_rbm_refuses_non_binary_hidden_units_with_jaxs_message():
    layer = jl.RBM(n_out=5, hidden_unit="gaussian")
    tlayer, params = _pair(layer)
    x = _x("binary")
    with pytest.raises(ValueError) as jerr:
        layer.pretrain_loss({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as terr:
        tlayer.pretrain_loss(interop.layer_params_from_jax(tlayer, params),
                             torch.from_numpy(x), None)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------- VariationalAutoencoder
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
@pytest.mark.parametrize("draws", [True, False])
def test_vae_elbo_matches_jax(dist, draws):
    """-ELBO with the gaussian or bernoulli reconstruction (two encoder and
    one decoder layer), its gradient, and apply = pzx_activation(mean)."""
    layer = jl.VariationalAutoencoder(
        n_out=3, encoder_layer_sizes=[6, 5], decoder_layer_sizes=[4],
        reconstruction_distribution=dist, pzx_activation="tanh")
    x = _x("unit" if dist == "bernoulli" else "normal")
    _apply_matches(layer, x)
    _assert_loss_matches(layer, x,
                         jax.random.PRNGKey(23) if draws else None)


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_vae_reconstruction_probability_matches_jax(dist):
    """The Monte-carlo log p(x) per row over 4 samples, sample i from
    fold_in(key, i), and its gradient."""
    layer = jl.VariationalAutoencoder(
        n_out=2, encoder_layer_sizes=[5], decoder_layer_sizes=[5],
        reconstruction_distribution=dist)
    x = _x("unit")
    (jl_, jg), (tl_, tg) = _loss_and_grads(
        layer, x, jax.random.PRNGKey(29), fn="reconstruction_probability",
        num_samples=4)
    assert abs(tl_ - jl_) <= 1e-5 * abs(jl_)
    for k in jg:
        assert _rel(tg[k], jg[k]) <= 1e-5, k
    tlayer, params = _pair(layer)
    want = layer.reconstruction_probability(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jax.random.PRNGKey(29), num_samples=4)
    got = tlayer.reconstruction_probability(
        interop.layer_params_from_jax(tlayer, params), torch.from_numpy(x),
        JaxKeys(jax.random.PRNGKey(29)), num_samples=4)
    assert got.shape == (x.shape[0],)
    assert _rel(got.numpy(), want) <= 1e-5


def test_vae_param_names_and_shapes_are_jaxs():
    layer = jl.VariationalAutoencoder(n_out=3, encoder_layer_sizes=[6, 5],
                                      decoder_layer_sizes=[4, 2])
    tlayer, params = _pair(layer)
    mine = tlayer.init_params(torch.Generator().manual_seed(0),
                              jit.feed_forward(N_IN))
    assert list(mine) == list(params)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in params.items()}


# --------------------------------------------------- layerwise pretraining
def _stack(updater):
    return (JNNC(seed=5, updater=updater).list([
        jl.AutoEncoder(n_out=6, corruption_level=0.3),
        jl.RBM(n_out=5, cd_k=2),
        jl.VariationalAutoencoder(n_out=3, encoder_layer_sizes=[4],
                                  decoder_layer_sizes=[4],
                                  reconstruction_distribution="bernoulli"),
        jl.Output(n_out=3, loss="mcxent", activation="softmax")])
        .set_input_type(jit.feed_forward(N_IN)))


def _nets(jconf):
    """The JAX network and the port's from its JSON with the JAX params
    and the JAX network's keys as its draws."""
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    assert tnet.conf.to_json() == jconf.to_json()
    tree = jax.tree_util.tree_map(np.asarray, jnet.params)
    interop.params_from_jax(tnet, tree,
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    tnet.draws = JaxKeys.for_net(jconf.defaults.seed)
    return jnet, tnet


def _same_params(tnet, jnet, tol=1e-5):
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    tt = tnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        assert np.abs(tt[k] - jt[k]).max() <= tol, k


def _data(n=24, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.random((n, N_IN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


@pytest.mark.parametrize("updater", ["sgd", "nesterovs"])
def test_pretrain_stack_then_fit_matches_jax(updater):
    """AutoEncoder -> RBM (CD-2) -> VAE -> Output: `pretrain` over 3
    batches of 8 for 2 epochs (each layer trained in turn on the
    inference-mode activations below it, one key per batch), then
    `pretrain_layer` of the RBM alone, then one fit step: params and
    score_ equal JAX's after each; the Output layer is untouched by
    pretraining."""
    upd = (jupd.Sgd(learning_rate=0.1) if updater == "sgd"
           else jupd.Nesterovs(learning_rate=0.05, momentum=0.9))
    jnet, tnet = _nets(_stack(upd))
    x, y = _data()
    out_before = tnet.get_param_table()["layer_3/W"].copy()
    jnet.pretrain(JListIterator(JDataSet(x, y), batch=8), epochs=2)
    tnet.pretrain(ListDataSetIterator(DataSet(x, y), batch=8), epochs=2)
    assert abs(tnet.score_ - float(jnet.score_)) <= \
        1e-5 * abs(float(jnet.score_))
    _same_params(tnet, jnet)
    assert np.array_equal(tnet.get_param_table()["layer_3/W"], out_before)
    jnet.pretrain_layer(1, JListIterator(JDataSet(x, y), batch=12))
    tnet.pretrain_layer(1, ListDataSetIterator(DataSet(x, y), batch=12))
    assert abs(tnet.score_ - float(jnet.score_)) <= \
        1e-5 * abs(float(jnet.score_))
    _same_params(tnet, jnet)
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert abs(tnet.score_ - float(jnet.score_)) <= \
        1e-5 * abs(float(jnet.score_))
    _same_params(tnet, jnet)
    assert tnet.iteration == 1  # pretraining counts no iterations


def test_pretrain_takes_a_dataset_and_the_layers_own_updater():
    """A DataSet pretrains as one batch; a layer with its own updater
    (RmsProp) and learning rate steps with it, fresh slots per call."""
    jconf = (JNNC(seed=8, updater=jupd.Sgd(learning_rate=0.1)).list([
        jl.AutoEncoder(n_out=4, updater=jupd.RmsProp(learning_rate=1e-2),
                       corruption_level=0.0),
        jl.Output(n_out=3, loss="mcxent")])
        .set_input_type(jit.feed_forward(N_IN)))
    jnet, tnet = _nets(jconf)
    x, y = _data(10, 4)
    for _ in range(2):
        jnet.pretrain(JDataSet(x, y))
        tnet.pretrain(DataSet(x, y))
        assert abs(tnet.score_ - float(jnet.score_)) <= \
            1e-5 * abs(float(jnet.score_))
        _same_params(tnet, jnet)


@pytest.mark.parametrize("idx", [0, 2])
def test_pretrain_layer_refuses_a_layer_without_an_objective(idx):
    """A Dense layer (0) and the Output layer (2) of Dense -> AutoEncoder
    -> Output: JAX's ValueError and message; `pretrain` skips them."""
    jconf = (JNNC(seed=5).list([
        jl.Dense(n_out=6), jl.AutoEncoder(n_out=4),
        jl.Output(n_out=3, loss="mcxent")])
        .set_input_type(jit.feed_forward(N_IN)))
    jnet, tnet = _nets(jconf)
    x, y = _data()
    with pytest.raises(ValueError) as jerr:
        jnet.pretrain_layer(idx, JDataSet(x, y))
    with pytest.raises(ValueError) as terr:
        tnet.pretrain_layer(idx, DataSet(x, y))
    assert str(terr.value) == str(jerr.value) == \
        f"layer {idx} has no pretrain objective"
    jnet.pretrain(JDataSet(x, y))
    tnet.pretrain(DataSet(x, y))
    _same_params(tnet, jnet)


def test_pretraining_ignores_l2_and_the_vae_its_distribution_in_both():
    """ROADMAP C.16, pinned in both packages: layerwise pretraining takes
    the raw updater step, so an l2 of 0.5 leaves the pretrained params as
    they are without it (fit applies it); the VAE draws its weights by
    `weight_init` without the layer's `dist` (a uniform on [5, 6] gives
    weights around 0)."""
    x, y = _data()
    tables = {}
    for l2 in (0.0, 0.5):
        jconf = (JNNC(seed=5, l2=l2, updater=jupd.Sgd(learning_rate=0.1))
                 .list([jl.AutoEncoder(n_out=4, corruption_level=0.0),
                        jl.Output(n_out=3, loss="mcxent")])
                 .set_input_type(jit.feed_forward(N_IN)))
        jnet, tnet = _nets(jconf)
        jnet.pretrain(JDataSet(x, y))
        tnet.pretrain(DataSet(x, y))
        _same_params(tnet, jnet)
        tables[l2] = tnet.get_param_table()
    for k, v in tables[0.0].items():
        assert np.array_equal(v, tables[0.5][k]), k
    dist = {"type": "uniform", "lower": 5.0, "upper": 6.0}
    layer = jl.VariationalAutoencoder(n_out=2, encoder_layer_sizes=[3],
                                      decoder_layer_sizes=[3],
                                      weight_init="distribution", dist=dist)
    jw = np.asarray(layer.init_params(jax.random.PRNGKey(0),
                                      jit.feed_forward(N_IN))["eW0"])
    tw = Layer.from_json(layer.to_json()).init_params(
        torch.Generator().manual_seed(0), jit.feed_forward(N_IN))["eW0"]
    assert abs(jw.mean()) < 1.0 and abs(float(tw.mean())) < 1.0
    dense = Layer.from_json(jl.Dense(n_out=3, weight_init="distribution",
                                     dist=dist).to_json())
    assert float(dense.init_params(torch.Generator().manual_seed(0),
                                   jit.feed_forward(N_IN))["W"].min()) >= 5.0


def test_pretrain_draws_from_the_networks_seeded_generator():
    """Without a stand-in the draws come from the network's generator:
    two networks of one seed pretrain to the same bits, another seed
    elsewhere."""
    def run(seed):
        conf = _stack(jupd.Sgd(learning_rate=0.1))
        conf.defaults.seed = seed
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json())).init(device="cpu")
        x, y = _data()
        net.pretrain(ListDataSetIterator(DataSet(x, y), batch=8))
        return net.get_param_table()

    a, b, c = run(5), run(5), run(6)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a if "layer_0" in k)


# ------------------------------------------------------------ persistence
@pytest.mark.parametrize("cls", ["AutoEncoder", "RBM",
                                 "VariationalAutoencoder"])
def test_jax_checkpoint_restores_and_computes_as_jax(tmp_path, cls):
    """A JAX network of the class under an Output, pretrained and fitted
    one step, written by the JAX package: the port restores it (params and
    updater slots), gives JAX's output and pretrain loss (JAX's key
    replayed), and its next fit step equals JAX's; the port's own zip
    restores in the JAX package."""
    layer = {"AutoEncoder": jl.AutoEncoder(n_out=4),
             "RBM": jl.RBM(n_out=4, visible_unit="gaussian"),
             "VariationalAutoencoder": jl.VariationalAutoencoder(
                 n_out=2, encoder_layer_sizes=[5],
                 decoder_layer_sizes=[5])}[cls]
    jconf = (JNNC(seed=4, updater=jupd.Nesterovs(learning_rate=0.05))
             .list([layer, jl.Output(n_out=3, loss="mcxent")])
             .set_input_type(jit.feed_forward(N_IN)))
    jnet = JMLN(jconf).init()
    x, y = _data(12, 6)
    jnet.pretrain(JDataSet(x, y))
    jnet.fit(x, y)
    path = tmp_path / "j.zip"
    jser.write_model(jnet, str(path))
    tnet = restore_model(str(path), device="cpu")
    jnet = jser.restore_model(str(path))
    assert type(tnet.layers[0]).__name__ == cls
    _same_params(tnet, jnet, tol=0.0)
    assert _rel(tnet.output(x).numpy(), np.asarray(jnet.output(x))) <= 1e-5
    key = jax.random.PRNGKey(31)
    want = jnet.layers[0].pretrain_loss(jnet.params["layer_0"],
                                        jnp.asarray(x), key)
    got = tnet.layers[0].pretrain_loss(tnet.params["layer_0"],
                                       torch.from_numpy(x), JaxKeys(key))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert abs(tnet.score_ - float(jnet.score_)) <= \
        1e-5 * abs(float(jnet.score_))
    _same_params(tnet, jnet)
    from deeplearning4j_tpu_torch.models import write_model

    back = tmp_path / "t.zip"
    write_model(tnet, str(back))
    again = jser.restore_model(str(back))
    _same_params(tnet, again, tol=0.0)


def test_layer_json_round_trips_both_ways():
    """Every field of the three classes (non-default values) crosses from
    either package to the other unchanged."""
    layers = [
        jl.AutoEncoder(n_in=9, n_out=4, corruption_level=0.1, sparsity=0.05,
                       activation="tanh", l2=1e-3),
        jl.RBM(n_out=3, visible_unit="gaussian", hidden_unit="binary",
               objective="reconstruction", cd_k=4, corruption_level=0.0),
        jl.VariationalAutoencoder(
            n_in=9, n_out=2, encoder_layer_sizes=[8, 6],
            decoder_layer_sizes=[5], reconstruction_distribution="bernoulli",
            pzx_activation="sigmoid", num_samples=7,
            activation="leakyrelu"),
    ]
    for jlayer in layers:
        d = json.loads(json.dumps(jlayer.to_json()))
        t = Layer.from_json(d)
        assert t.to_json() == d
        assert JLayer.from_json(t.to_json()).to_json() == d
    t = VariationalAutoencoder(n_out=2, encoder_layer_sizes=[3])
    assert JLayer.from_json(t.to_json()).to_json() == t.to_json()
    assert isinstance(Layer.from_json(RBM(n_out=2).to_json()), AutoEncoder)
