"""The training slice against the JAX package: losses, updater rules,
gradient normalization, schedules, constraints, datasets, and
MultiLayerNetwork.fit of a small TransformerLM step by step.

Inputs and weights are made with numpy from a seed (weights carried into
the port by `interop.params_from_jax`), float32 on both sides. Tolerances:
  - losses, rules, normalization, constraints: 1e-5 relative to the
    largest magnitude (the same float32 operations; sums in another
    order); schedules 1e-6 (the port computes in double, JAX in float32);
  - fit, per-step score_ 1e-5 relative; Adam slots m and v 1e-4 of each
    leaf's largest magnitude; params 5e-5 absolute: Adam divides each
    gradient element by its own magnitude, so an element whose true
    gradient is zero (the attention key bias, to which softmax is
    invariant) moves by lr * noise / (|noise| + eps) in each program, up to
    lr = 3e-4 a step (measured: 8.4e-6 after 3 steps); SGD-family fits
    1e-5 absolute;
  - mixed precision (bf16 activations in both packages, rounded at other
    places): scores 1e-2 relative, each leaf's change from its start 0.2
    in relative L2 norm, slots 5e-2 (see the test).
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.datasets import dataset as jds_mod
from deeplearning4j_tpu.datasets import iterators as jit_mod
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn import regularization as jreg
from deeplearning4j_tpu.nn import schedules as jsched
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import losses as tlosses
from deeplearning4j_tpu_torch.nn import regularization as treg
from deeplearning4j_tpu_torch.nn import schedules as tsched
from deeplearning4j_tpu_torch.nn import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from torch_keys import JaxKeys

CFG = dict(num_classes=64, max_length=16, d_model=32, n_heads=2, n_layers=2)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- losses
LOSSES = [("mcxent", "softmax"), ("negativeloglikelihood", "softmax"),
          ("mcxent", "sigmoid"), ("mse", "identity"), ("l2", "identity"),
          ("l1", "tanh"), ("mae", "identity"), ("xent", "sigmoid"),
          ("kld", "softmax"), ("poisson", "softplus"),
          ("mape", "identity"), ("msle", "relu"), ("hinge", "identity"),
          ("squared_hinge", "identity"), ("cosine_proximity", "identity"),
          ("expll", "softplus"), ("wasserstein", "identity")]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss,act", LOSSES)
def test_losses_match_jax(loss, act, masked):
    rng = np.random.default_rng(len(loss) + len(act))
    z = rng.standard_normal((3, 5, 7)).astype(np.float32)
    y = rng.random((3, 5, 7)).astype(np.float32)
    m = None
    if masked:
        m = (rng.random((3, 5)) > 0.4).astype(np.float32)
        m[2] = 0.0  # a fully masked row: the count is clamped at 1
    js, jper = jlosses.compute(loss, jnp.asarray(y), jnp.asarray(z),
                               jact.get(act), mask=None if m is None
                               else jnp.asarray(m))
    ts, tper = tlosses.compute(loss, _t(y), _t(z), tact.get(act),
                               mask=None if m is None else _t(m))
    assert ts.dtype == torch.float32 and tper.shape == (3, 5)
    assert _rel(ts, js) < 1e-5
    assert _rel(tper, jper) < 1e-5


def test_losses_widen_bfloat16_and_take_trailing_singleton_masks():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 4, 6)).astype(ml_dtypes.bfloat16)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (2, 4))]
    m = np.ones((2, 4, 1), np.float32)
    m[0, 2:] = 0
    js, _ = jlosses.compute("mcxent", jnp.asarray(y), jnp.asarray(z),
                            jact.get("softmax"), mask=jnp.asarray(m))
    ts, _ = tlosses.compute("mcxent", _t(y),
                            _t(z.astype(np.float32)).bfloat16(),
                            tact.get("softmax"), mask=_t(m))
    assert ts.dtype == torch.float32 and _rel(ts, js) < 1e-5
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get("nope")
    assert tlosses.names() == jlosses.names()


# ----------------------------------------------------- updater rules
def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"W": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal(3) * scale).astype(np.float32),
            "attn": {"Wo": (rng.standard_normal(5) * scale).astype(
                np.float32)}}


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return _t(tree)


def _assert_trees(got, want, tol, what):
    if isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees(g, w, tol, f"{what}[{i}]")
        return
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_trees(got[k], want[k], tol, f"{what}/{k}")
        return
    if isinstance(want, tuple):
        assert got == () and want == (), what
        return
    w = np.asarray(want)
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    if w.dtype.kind in "iu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        assert _rel(np.asarray(g), w) <= tol, (what, _rel(np.asarray(g), w))


@pytest.mark.parametrize("name", sorted(jupd._TYPES))
def test_updater_rules_match_jax_over_steps(name):
    ju, tu = jupd._TYPES[name](), tupd._TYPES[name]()
    assert tu.to_json() == ju.to_json()
    params = _tree(0)
    jstate = ju.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tstate = tu.init_state(_to_t(params))
    lr = 0.05
    for step in range(4):
        g = _tree(10 + step, scale=0.1 * (step + 1))
        jsteps, jstate = ju.apply(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, lr)
        tsteps, tstate = tu.apply(_to_t(g), tstate, lr)
        _assert_trees(tsteps, jsteps, 1e-5, f"{name} steps {step}")
        _assert_trees(tstate, jstate, 1e-5, f"{name} state {step}")


@pytest.mark.parametrize("mode", [None, "RenormalizeL2PerLayer",
                                  "RenormalizeL2PerParamType",
                                  "ClipElementWiseAbsoluteValue",
                                  "ClipL2PerLayer", "ClipL2PerParamType"])
@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_normalize_gradients_matches_jax(mode, scale):
    g = _tree(4, scale=scale)
    want = jupd.normalize_gradients(jax.tree_util.tree_map(jnp.asarray, g),
                                    mode, 0.5)
    got = tupd.normalize_gradients(_to_t(g), mode, 0.5)
    _assert_trees(got, want, 1e-5, str(mode))
    with pytest.raises(ValueError):
        tupd.normalize_gradients(_to_t(g), "Bogus")


# ------------------------------------------------------------ schedules
SCHEDULES = [tsched.NoneSchedule(), tsched.ExponentialSchedule(0.95),
             tsched.InverseSchedule(0.01, 0.75), tsched.PolySchedule(2.0, 50),
             tsched.SigmoidSchedule(0.1, 20), tsched.StepSchedule(0.5, 7),
             tsched.TorchStepSchedule(0.5, 7),
             tsched.MapSchedule({0: 0.2, 5: 0.05, 30: 0.01}),
             tsched.WarmupCosineSchedule(10, 100, 0.1)]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: type(s).__name__)
def test_schedules_match_jax(sched):
    jschedule = jsched.from_json(json.loads(json.dumps(sched.to_json())))
    for it in (0, 1, 6, 7, 13, 40, 99, 500):
        want = float(jschedule(0.1, jnp.asarray(it)))
        got = sched(0.1, it)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (it, got,
                                                                  want)


# ---------------------------------------------------------- constraints
@pytest.mark.parametrize("constraint", [
    {"type": "MaxNorm", "max_norm": 0.8},
    {"type": "MinMaxNorm", "min_norm": 0.5, "max_norm": 1.0, "rate": 0.7},
    {"type": "UnitNorm"}, {"type": "NonNegative"}])
def test_constraints_match_jax(constraint):
    params = {"W": np.random.default_rng(1).standard_normal(
        (4, 3)).astype(np.float32), "b": np.array([-1.0, 2.0, -3.0],
                                                  np.float32),
              "v": np.array([3.0, -4.0], np.float32)}
    want = jreg.apply_constraints(
        jax.tree_util.tree_map(jnp.asarray, params), [constraint])
    got = treg.apply_constraints(_to_t(params), [constraint])
    _assert_trees(got, want, 1e-6, constraint["type"])
    nested = treg.apply_constraints({"attn": _to_t(params)}, [constraint])
    _assert_trees(nested["attn"], want, 1e-6, "nested")


# ------------------------------------------------------------- datasets
def test_dataset_and_iterator_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    y = rng.standard_normal((10, 2)).astype(np.float32)
    m = np.ones((10, 1), np.float32)
    jd, td = jds_mod.DataSet(x, y, None, m), DataSet(x, y, None, m)
    jd.shuffle(4)
    td.shuffle(4)
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(td.labels_mask, jd.labels_mask)
    jb = list(jit_mod.ListDataSetIterator(jd, batch=4))
    tb = list(ListDataSetIterator(td, batch=4))
    assert [b.num_examples() for b in tb] == [b.num_examples()
                                              for b in jb] == [4, 4, 2]
    merged = DataSet.merge(tb)
    np.testing.assert_array_equal(merged.features, td.features)
    a, b = DataSet(_t(x), _t(y)).split_test_and_train(7)
    assert a.num_examples() == 7 and b.num_examples() == 3
    ts = DataSet(_t(x), _t(y))
    ts.shuffle(4)
    np.testing.assert_array_equal(ts.features.numpy(), jd.features)
    assert isinstance(ListDataSetIterator(td), DataSetIterator)
    it = ListDataSetIterator(td, batch=5).set_pre_processor(
        lambda d: DataSet(d.features * 0, d.labels))
    assert all(float(abs(b.features).max()) == 0 for b in it)


# --------------------------------------------------- the slice as a whole
def _jax_table(jnet):
    flat = {}

    def put(prefix, v):
        v = v.item() if isinstance(v, np.ndarray) and v.dtype == object else v
        if isinstance(v, dict):
            for k, sub in v.items():
                put(f"{prefix}/{k}", sub)
        else:
            flat[prefix] = np.asarray(v)

    for key, v in jnet.get_param_table().items():
        put(key, v)
    return flat


def _lm_conf_json(attention_impl="auto"):
    d = json.loads(JTransformerLM(**CFG).conf().to_json())
    for layer in d["layers"]:
        if layer["type"] == "TransformerBlock":
            layer["attention_impl"] = attention_impl
    return json.dumps(d)


def _pair(conf_json, perturb_seed=2025):
    """A JAX network and a port network with the same weights, the JAX
    LayerNorm gains and biases made non-trivial first."""
    jnet = JMLN(JConf.from_json(conf_json)).init()
    rng = np.random.default_rng(perturb_seed)
    params = jax.tree_util.tree_map(np.asarray, jnet.params)

    def walk(p):
        for key in list(p):
            if isinstance(p[key], dict):
                walk(p[key])
            elif key == "gamma":
                p[key] = rng.uniform(0.5, 1.5, p[key].shape).astype(
                    np.float32)
            elif key == "beta" or key.startswith("b"):
                p[key] = (rng.standard_normal(p[key].shape) * 0.1).astype(
                    np.float32)
    walk(params)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, jnet.state)
    tnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(conf_json)).init(device="cpu")
    interop.params_from_jax(tnet, params, state)
    return jnet, tnet


def _lm_batch(seed, n=4, t=16, vocab=64):
    ids = np.random.default_rng(seed).integers(0, vocab, (n, t + 1))
    return (ids[:, :t].astype(np.int32),
            np.eye(vocab, dtype=np.float32)[ids[:, 1:]])


def _compare_nets(jnet, tnet, param_tol, slot_tol=1e-4):
    jt, tt = _jax_table(jnet), tnet.get_param_table()
    assert list(tt) == list(jt)
    worst = max(float(np.abs(tt[k] - jt[k]).max()) for k in jt)
    assert worst <= param_tol, worst
    for i, (got, want) in enumerate(zip(interop.opt_state_to_jax(tnet),
                                        jnet.opt_state)):
        _assert_trees(got, want, slot_tol, f"opt_state[{i}]")
    assert tnet.iteration == jnet.iteration


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_transformer_lm_fit_matches_jax_step_by_step(impl):
    """3 Adam steps on 3 batches. With "pallas" the JAX network runs its
    flash-attention kernel pair in interpret mode; with "auto" it takes
    sdpa on the CPU. The port takes the flash kernels' plain versions and
    the fused xent route either way."""
    jnet, tnet = _pair(_lm_conf_json(impl))
    for step in range(3):
        x, y = _lm_batch(step)
        jnet.fit(jds_mod.DataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_), (
            step, tnet.score_, jnet.score_)
        assert tnet.last_batch_size == jnet.last_batch_size == 4
    _compare_nets(jnet, tnet, param_tol=5e-5)


def test_transformer_lm_mixed_precision_fit_matches_jax():
    """3 Adam steps under bf16 activations in both packages. Each leaf's
    change from its start is held as a whole: the L2 norm of the port's
    change minus JAX's within 0.2 of JAX's (measured worst 0.081; a step
    that moves nothing gives 1). Adam divides each gradient element by its
    own size, so an element whose gradient is within bf16 rounding of zero
    moves by up to lr either way, and elementwise changes differ by as much
    as a step. The key bias (the middle third of bqkv; softmax is invariant
    to it, so its true gradient is zero) is all such noise and is held only
    to Adam's bound of lr per step. Slots m and v 5e-2 of each leaf's
    largest magnitude (measured worst 3.4e-2: v squares the gradient's
    bf16 error)."""
    jnet, tnet = _pair(_lm_conf_json())
    start = {k: v.copy() for k, v in tnet.get_param_table().items()}
    steps, lr = 3, 3e-4
    with jdtypes.mixed(), tdtypes.mixed():
        for step in range(steps):
            x, y = _lm_batch(10 + step)
            jnet.fit(jds_mod.DataSet(x, y))
            tnet.fit(DataSet(x, y))
            assert abs(tnet.score_ - jnet.score_) <= 1e-2 * abs(
                jnet.score_)
    jt, tt = _jax_table(jnet), tnet.get_param_table()
    assert all(tt[k].dtype == np.float32 for k in tt)
    key_bias = np.arange(CFG["d_model"], 2 * CFG["d_model"])
    for k in jt:
        want, got = jt[k] - start[k], tt[k] - start[k]
        if k.endswith("attn/bqkv"):
            assert np.abs(got[key_bias]).max() <= 1.01 * steps * lr, k
            want, got = np.delete(want, key_bias), np.delete(got, key_bias)
        assert np.linalg.norm(want) > 0, k
        assert np.linalg.norm(got - want) <= 0.2 * np.linalg.norm(want), (
            k, np.linalg.norm(got - want) / np.linalg.norm(want))
    for i, (got, want) in enumerate(zip(interop.opt_state_to_jax(tnet),
                                        jnet.opt_state)):
        _assert_trees(got, want, 5e-2, f"opt_state[{i}]")
        if got:
            assert int(got["t"]) == int(want["t"]) == steps


def test_jax_run_resumes_in_the_port():
    """2 steps in JAX, params and updater slots carried across, then one
    more step in each: the same step."""
    jnet, tnet = _pair(_lm_conf_json())
    for step in range(2):
        jnet.fit(jds_mod.DataSet(*_lm_batch(20 + step)))
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    interop.params_from_jax(tnet, params,
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    interop.opt_state_from_jax(tnet, jax.tree_util.tree_map(np.asarray,
                                                            jnet.opt_state))
    tnet.iteration = jnet.iteration
    x, y = _lm_batch(22)
    jnet.fit(jds_mod.DataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    _compare_nets(jnet, tnet, param_tol=5e-5)


def test_opt_state_round_trips_and_rejects_mismatches():
    jnet, tnet = _pair(_lm_conf_json())
    tnet.fit(DataSet(*_lm_batch(30)))
    out = interop.opt_state_to_jax(tnet)
    assert out[0]["t"].dtype == np.int32 and int(out[0]["t"]) == 1
    assert set(out[2]) == {"m", "v", "t"} and "attn" in out[2]["m"]
    fresh = MultiLayerNetwork(tnet.conf).init(device="cpu")
    interop.opt_state_from_jax(fresh, out)
    _assert_trees(interop.opt_state_to_jax(fresh), out, 0.0, "round trip")
    jtree = jax.tree_util.tree_map(jnp.asarray, out)
    jnet.opt_state = jtree  # the JAX network takes the port's slots as-is
    jnet.fit(jds_mod.DataSet(*_lm_batch(31)))
    assert int(jnet.opt_state[0]["t"]) == 2
    bad = interop.opt_state_to_jax(tnet)
    del bad[2]["m"]["W1"]
    with pytest.raises(ValueError):
        interop.opt_state_from_jax(fresh, bad)
    with pytest.raises(ValueError):
        interop.opt_state_from_jax(fresh, out[:-1])
    bad = interop.opt_state_to_jax(tnet)
    bad[0]["m"]["W"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        interop.opt_state_from_jax(fresh, bad)


# ------------------------------------------------------- fit's contract
def _dense_conf(**defaults):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn import inputs as it
    from deeplearning4j_tpu_torch.nn.layers import Dense, Output

    return NeuralNetConfiguration(seed=3, **defaults).list([
        Dense(n_out=6, activation="tanh", l1=1e-3,
              constraints=[{"type": "MaxNorm", "max_norm": 0.9}]),
        Output(n_out=4, loss="mcxent", activation="softmax", l2_bias=1e-2),
    ]).set_input_type(it.feed_forward(5))


@pytest.mark.parametrize("updater,extra", [
    ("sgd", {}), ("nesterovs", {"gradient_normalization": "ClipL2PerLayer",
                                "gradient_normalization_threshold": 0.3}),
    ("rmsprop", {"lr_schedule": tsched.StepSchedule(0.5, 2)}),
    ("adagrad", {"l2": 1e-2})])
def test_dense_fit_matches_jax_with_penalties_and_constraints(updater, extra):
    """Penalties (layer l1, default l2, bias l2), constraints, gradient
    normalization and a schedule through fit, against the JAX fit."""
    conf = _dense_conf(updater=updater, **extra)
    jnet = JMLN(JConf.from_json(conf.to_json())).init()
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    tnet = MultiLayerNetwork(conf).init(device="cpu")
    interop.params_from_jax(tnet, params,
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((12, 5)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 12)]
    jnet.fit(jit_mod.ListDataSetIterator(jds_mod.DataSet(x, y), batch=5),
             epochs=2)
    seen = []

    class Listener:
        def iteration_done(self, net, iteration, score):
            seen.append((iteration, score))

    tnet.set_listeners(Listener())
    tnet.fit(ListDataSetIterator(DataSet(x, y), batch=5), epochs=2)
    assert [i for i, _ in seen] == list(range(1, 7))
    assert tnet.iteration == jnet.iteration == 6 and tnet.epoch == 2
    assert tnet.last_batch_size == 2
    assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    _compare_nets(jnet, tnet, param_tol=1e-5, slot_tol=1e-5)
    ds = jds_mod.DataSet(x, y)
    assert abs(tnet.score(DataSet(x, y)) - jnet.score(ds)) <= 1e-5 * abs(
        jnet.score(ds))


def test_fit_takes_features_and_labels_and_frozen_layers_stay():
    conf = _dense_conf(updater="sgd")
    net = MultiLayerNetwork(conf).init(device="cpu")
    before = {k: v.copy() for k, v in net.get_param_table().items()}
    net.layers[0].frozen = True
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((6, 5)))
    y = _t(np.eye(4)[rng.integers(0, 4, 6)])
    assert net._batch(x) is x  # a batch already on the device: no copy
    net.fit(x, y)
    after = net.get_param_table()
    np.testing.assert_array_equal(after["layer_0/W"], before["layer_0/W"])
    assert not np.array_equal(after["layer_1/W"], before["layer_1/W"])
    assert np.isfinite(net.score_) and net.iteration == 1
    with pytest.raises(TypeError):
        net.fit("not a dataset")


@pytest.mark.parametrize("where", ["block_dropout", "attn_dropout",
                                   "weight_noise", "solver", "tbptt"])
def test_fit_refuses_what_it_does_not_train(where):
    """fit refuses none of these: each trains as the JAX package's does.
    solver: 2 LBFGS iterations (one per batch) against the JAX fit. The
    TransformerBlock's FFN dropout, a MultiHeadAttention's attn_dropout and
    DropConnect on a block's weights: 3 Adam steps with the JAX network's
    keys replayed into the port's draws, against the JAX fit. tbptt: the
    TransformerLM feeds [b, t] token ids, which cannot be cut into
    windows, so a tBPTT configuration takes the standard step, one
    iteration per batch, as the JAX package's fit does."""
    d = json.loads(_lm_conf_json())
    if where == "block_dropout":
        d["layers"][2]["dropout"] = 0.9
    elif where == "attn_dropout":
        d["layers"].insert(2, {"type": "MultiHeadAttention", "n_heads": 2,
                               "attn_dropout": 0.9})
    elif where == "weight_noise":
        d["layers"][3]["weight_noise"] = {"type": "DropConnect", "p": 0.5}
    elif where == "solver":
        d["defaults"]["optimization_algo"] = "lbfgs"
    if where in ("block_dropout", "attn_dropout", "weight_noise"):
        jnet, tnet = _pair(json.dumps(d))
        tnet.draws = JaxKeys.for_net(d["defaults"]["seed"])
        for step in range(3):
            x, y = _lm_batch(20 + step)
            jnet.fit(jds_mod.DataSet(x, y))
            tnet.fit(DataSet(x, y))
            assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(
                jnet.score_), (step, tnet.score_, jnet.score_)
        # the LM's bound in this file (test_transformer_lm_fit_matches_jax_
        # step_by_step); measured 1.2e-5 with dropout
        _compare_nets(jnet, tnet, param_tol=5e-5)
        return
    if where == "tbptt":
        d["defaults"]["backprop_type"] = "tbptt"
        d["defaults"]["tbptt_fwd_length"] = 4
        jnet, tnet = _pair(json.dumps(d))
        x, y = _lm_batch(0)
        assert not tnet._tbptt_batch(DataSet(x, y))
        jnet.fit(jds_mod.DataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert tnet.iteration == jnet.iteration == 1
        assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
        _compare_nets(jnet, tnet, param_tol=5e-5)
        return
    # solver: the line-search solvers train now (tests/test_torch_solvers
    # .py): 2 LBFGS iterations against the JAX network's solver path
    jnet, tnet = _pair(json.dumps(d))
    for step in range(2):
        x, y = _lm_batch(20 + step)
        jnet.fit(jds_mod.DataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(
            jnet.score_), (step, tnet.score_, jnet.score_)
    _compare_nets(jnet, tnet, param_tol=5e-5)
