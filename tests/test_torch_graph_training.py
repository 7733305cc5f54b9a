"""The graph-training slice against the JAX package: BatchNorm in train
mode, ComputationGraph.fit of a small ResNet-shaped graph and of zoo
ResNet50 step by step, fit's input forms and contract, and the graph's
updater slots through `interop`.

Inputs and weights are made with numpy from a seed (weights carried into
the port by `interop.params_from_jax`) and handed to both packages.
Tolerances:
  - BatchNorm, float32: outputs, new running stats and the gradients of x,
    gamma and beta 1e-5 relative to each one's largest magnitude (the same
    float32 operations; sums in another order); bfloat16 x: the running
    stats 1e-5 (float32 statistics of the same bfloat16 values), outputs
    and gradients 1e-2 (one bfloat16 rounding apart);
  - the small graph, float32: per-step scores 1e-5 relative, params 1e-5
    absolute, BN running stats and Nesterovs slots 1e-4 of each leaf's
    largest magnitude; mixed precision: the norm form of
    tests/test_torch_training.py's mixed test (see the test);
  - zoo ResNet50: see its test.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.models import ComputationGraph as JCG
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JGConf,
)
from deeplearning4j_tpu.nn.layers import BatchNorm as JBatchNorm
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import BatchNorm
from deeplearning4j_tpu_torch.ops import bn_act as bn_ops
from deeplearning4j_tpu_torch.zoo import ResNet50
from torch_graphs import small_resnet_json as _small_graph_json
from torch_keys import JaxKeys


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------ BatchNorm, train
# (input shape, dtype, offset): an offset of 1e3 over a std of 0.1 checks
# the two-reduce variance, where E[x^2] - E[x]^2 in float32 would cancel
BN_CASES = [((6, 5), "float32", 0.0), ((3, 4, 4, 5), "float32", 0.0),
            ((6, 5), "float32", 1e3), ((3, 4, 4, 5), "float32", 1e3),
            ((6, 5), "bfloat16", 0.0), ((3, 4, 4, 5), "bfloat16", 0.0)]


def _norm_rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(np.asarray(want, np.float32))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("shape,dname,offset", BN_CASES)
def test_batchnorm_train_matches_jax(shape, dname, offset, lock, act):
    """Outputs, new running stats (EMA of the batch mean and biased
    variance) and the gradients of x, gamma and beta. The statistics are
    float32 in both packages and agree to 1e-5 of their largest magnitude
    in every case (measured worst 2.3e-7). Outputs and gradients: float32
    1e-5 (measured 4.2e-7); at |mean| / std = 1e4 the fold's
    x * scale + shift cancels four digits in both packages, and XLA fuses
    it into one multiply-add where PyTorch rounds twice, so 1e-2 (measured
    1.9e-3), with the variance itself held to float64 at 1e-3; bfloat16
    outputs 1e-2 (one rounding apart; measured 0) and gradients, summed in
    bfloat16 products in both packages, 2e-2 in relative L2 norm (measured
    1.1e-2)."""
    rng = np.random.default_rng(len(shape) + int(offset) + lock)
    c = shape[-1]
    std = 0.1 if offset else 1.0
    x32 = (offset + std * rng.standard_normal(shape)).astype(np.float32)
    npd, jd, td = {"float32": (np.float32, jnp.float32, torch.float32),
                   "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16,
                                torch.bfloat16)}[dname]
    x = x32.astype(npd)
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": (rng.standard_normal(c) * 0.2).astype(np.float32)}
    if lock:
        params = {}
    state = {"mean": (rng.standard_normal(c) * 0.3).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    cot = rng.standard_normal(shape).astype(np.float32)
    cfg = dict(lock_gamma_beta=lock, activation=act, decay=0.8)
    jlayer, tlayer = JBatchNorm(**cfg), BatchNorm(**cfg)

    def jfn(p, xx):
        return jlayer.apply(p, xx, state=jax.tree_util.tree_map(
            jnp.asarray, state), train=True, rng=None)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (jy, jst), vjp = jax.vjp(jfn, jp, jnp.asarray(x, jd))
    jgp, jgx = vjp((jnp.asarray(cot, jd), jax.tree_util.tree_map(
        jnp.zeros_like, jst)))

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in
          params.items()}
    tx = torch.from_numpy(x32).to(td).requires_grad_()
    ty, tst = tlayer.apply(tp, tx, state={k: torch.from_numpy(v) for k, v in
                                          state.items()}, train=True)
    grads = torch.autograd.grad(ty, [tx, *tp.values()],
                                torch.from_numpy(cot).to(td))
    assert ty.dtype == td and ty.shape == tx.shape
    assert all(v.dtype == torch.float32 and not v.requires_grad
               for v in tst.values())
    for k in ("mean", "var"):
        assert _rel(tst[k], jst[k]) <= 1e-5, k
    pairs = [("x", grads[0], jgx)] + [(k, g, jgp[k]) for g, k in
                                      zip(grads[1:], tp)]
    if dname == "bfloat16":
        assert _rel(ty, jy) <= 1e-2
        for k, g, want in pairs:
            assert _norm_rel(g, want) <= 2e-2, k
        return
    tol = 1e-2 if offset else 1e-5
    assert _rel(ty, jy) <= tol
    for k, g, want in pairs:
        assert _rel(g, want) <= tol, k
    if offset:
        var = tlayer.batch_stats(tx.detach())[1].double().numpy()
        want = x32.astype(np.float64).reshape(-1, c).var(0)
        assert np.abs(var - want).max() <= 1e-3 * want.max()


def test_batchnorm_inference_keeps_state_and_other_dtypes_take_the_plain_epilogue(
        monkeypatch):
    """Eval mode hands back the same running-state dict; a float64 x (a
    user's input, which no precision policy casts) is outside the kernel's
    dtypes and takes the plain epilogue, on the CPU as on the card."""
    layer = BatchNorm(activation="relu")
    state = {"mean": torch.zeros(3), "var": torch.ones(3)}
    params = {"gamma": torch.ones(3), "beta": torch.zeros(3)}
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    y, st = layer.apply(params, x, state=state, train=False)
    assert st is state

    def refuse(*a, **k):
        raise AssertionError("bn_act reached with a dtype it refuses")

    monkeypatch.setattr(bn_ops, "bn_act", refuse)
    y64, _ = layer.apply(params, x.double(), state=state, train=False)
    assert y64.dtype == torch.float64
    torch.testing.assert_close(y64.float(), y, rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError, match="refuses"):
        layer.apply(params, x, state=state, train=False)


# -------------------------------------------------- the small graph
def _pair(conf_json, perturb=True):
    """A JAX graph and a port graph with the same weights and running
    state; with `perturb` the BN gammas, betas and running stats are made
    non-trivial first."""
    jnet = JCG(JGConf.from_json(conf_json)).init()
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    state = jax.tree_util.tree_map(np.asarray, jnet.state)
    if perturb:
        rng = np.random.default_rng(99)
        for name, st in state.items():
            if "mean" in st:
                c = st["mean"].shape[0]
                st["mean"] = (rng.standard_normal(c) * 0.3).astype(
                    np.float32)
                st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
                params[name]["gamma"] = rng.uniform(0.5, 1.5, c).astype(
                    np.float32)
                params[name]["beta"] = (rng.standard_normal(c) * 0.2
                                        ).astype(np.float32)
        jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
        jnet.state = jax.tree_util.tree_map(jnp.asarray, state)
    tnet = ComputationGraph(
        ComputationGraphConfiguration.from_json(conf_json)).init(device="cpu")
    interop.params_from_jax(tnet, params, state)
    return jnet, tnet


def _batch(seed, n=4, shape=(16, 16, 3), classes=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


def _state_err(jnet, tnet):
    return max(_rel(tnet.state[k][s], jnet.state[k][s])
               for k in jnet.state for s in jnet.state[k])


def _slot_errs(jnet, tnet, slot="v"):
    """{vertex/param: relative error} of one updater slot."""
    got = interop.opt_state_to_jax(tnet)
    assert set(got) == set(jnet.opt_state)
    out = {}
    for name, want in jnet.opt_state.items():
        g = dict(flat_items(got[name][slot]))
        w = jax.tree_util.tree_map(np.asarray, want[slot])
        assert set(g) == set(w), name
        for path, arr in w.items():
            out[f"{name}/{path}"] = _rel(g[path], arr)
    return out


def test_small_graph_fit_matches_jax_step_by_step():
    jnet, tnet = _pair(_small_graph_json())
    for step in range(3):
        x, y = _batch(step)
        jnet.fit(jds.DataSet(x, y))
        tnet.fit(DataSet(x, y))
        assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_), (
            step, tnet.score_, jnet.score_)
    jt, tt = jnet.get_param_table(), tnet.get_param_table()
    assert list(tt) == list(jt)
    worst = max(float(np.abs(tt[k] - np.asarray(jt[k])).max()) for k in jt)
    assert worst <= 1e-5, worst
    assert _state_err(jnet, tnet) <= 1e-4
    assert max(_slot_errs(jnet, tnet).values()) <= 1e-4
    assert tnet.iteration == jnet.iteration == 3
    assert tnet.params["stem_conv"]["W"].is_contiguous(
        memory_format=torch.channels_last)
    assert tnet.opt_state["stem_conv"]["v"]["W"].is_contiguous(
        memory_format=torch.channels_last)


def _sync(tnet, jnet):
    """The port graph takes the JAX graph's params, state, slots and
    iteration."""
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    interop.opt_state_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.opt_state))
    tnet.iteration = jnet.iteration


# the stem BN's beta moves relu'd values that pass max pooling into two
# train-mode BNs, which subtract any per-channel shift: its float32
# gradient is 1e-8, so under bf16 activations each package's is rounding
# noise
NOISE_ONLY = "stem_bn/beta"


def test_small_graph_mixed_precision_fit_matches_jax():
    """3 Nesterovs steps under bf16 activations in both packages, each
    step from the same point: before each step the port takes the JAX
    graph's params, state and slots. At these widths bf16 rounding moves
    BatchNorm's gradients a long way (JAX's own eager mixed gradients are
    40% from its float32 ones in relative L2 norm), so three steps at lr
    0.1 from points that drifted apart would compare two noisy
    trajectories rather than two steps. Per step: score 1e-2 relative
    (measured 2.3e-3); the new BN running stats 1e-2 of each leaf's
    largest magnitude (measured 2.3e-3); each leaf's change in that step
    and each Nesterovs slot within 0.4 of JAX's in relative L2 norm
    (measured 0.29; the norm form of tests/test_torch_training.py's mixed
    test, since element by element the bf16 roundings differ);
    NOISE_ONLY's change within 2e-2 (measured 1.0e-2)."""
    jnet, tnet = _pair(_small_graph_json())
    with jdtypes.mixed(), tdtypes.mixed():
        for step in range(3):
            _sync(tnet, jnet)
            before = tnet.get_param_table()
            x, y = _batch(10 + step)
            jnet.fit(jds.DataSet(x, y))
            tnet.fit(DataSet(x, y))
            assert abs(tnet.score_ - jnet.score_) <= 1e-2 * abs(
                jnet.score_), step
            jt, tt = jnet.get_param_table(), tnet.get_param_table()
            assert all(tt[k].dtype == np.float32 for k in tt)
            for k in jt:
                want, got = np.asarray(jt[k]) - before[k], tt[k] - before[k]
                if k == NOISE_ONLY:
                    assert np.abs(got).max() <= 2e-2, step
                    continue
                assert np.linalg.norm(got - want) <= 0.4 * np.linalg.norm(
                    want), (step, k)
            assert _state_err(jnet, tnet) <= 1e-2, step
            got = interop.opt_state_to_jax(tnet)
            for name, want in jnet.opt_state.items():
                g = dict(flat_items(got[name]["v"]))
                for path, w in jax.tree_util.tree_map(
                        np.asarray, want["v"]).items():
                    assert g[path].dtype == np.float32
                    if f"{name}/{path}" != NOISE_ONLY:
                        assert np.linalg.norm(g[path] - w) <= 0.4 * \
                            np.linalg.norm(w), (step, name, path)


# --------------------------------------------------------- zoo ResNet50
def test_zoo_resnet50_fit_matches_jax():
    """Zoo ResNet50 (10 classes, 64x64x3) at batch 4, its own config
    (Nesterovs(0.1, 0.9), l2 1e-4), 2 steps. Train-mode BatchNorm
    renormalizes at every block, so float32 rounding differences between
    the two programs grow through the network (every vertex within 3.4e-4
    of its largest magnitude at s5, against 1.2e-6 after the stem), and at
    s5, where each channel's statistics span 16 values, single relu inputs
    near zero change sign between the programs; each flip changes that
    channel's gradient. Measured: step 1's score 4.0e-5 relative (tol
    1e-4); after it, each leaf's change from its start within 0.065 in
    relative L2 norm (tol 0.1), the BN running stats 4.6e-5 of each leaf's
    largest magnitude (tol 1e-4); step 1 sends the score from 4.4 to 66,
    and step 2's score agrees to 2.1e-2 (tol 5e-2)."""
    jnet = JResNet50(num_classes=10, input_shape=(64, 64, 3)).init()
    tnet = ResNet50(num_classes=10, input_shape=(64, 64, 3)).init(
        device="cpu")
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    start = {k: v.copy() for k, v in tnet.get_param_table().items()}
    x, y = _batch(1, shape=(64, 64, 3), classes=10)
    jnet.fit(jds.DataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - jnet.score_) <= 1e-4 * abs(jnet.score_)
    jt, tt = jnet.get_param_table(), tnet.get_param_table()
    for k in jt:
        want, got = np.asarray(jt[k]) - start[k], tt[k] - start[k]
        assert np.linalg.norm(got - want) <= 0.1 * np.linalg.norm(want), k
    assert _state_err(jnet, tnet) <= 1e-4
    x, y = _batch(2, shape=(64, 64, 3), classes=10)
    jnet.fit(jds.DataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - jnet.score_) <= 5e-2 * abs(jnet.score_)
    assert np.isfinite(tnet.score_) and tnet.iteration == 2


# --------------------------------------------------- fit's contract
class ScoreLog:
    def __init__(self):
        self.seen = []

    def iteration_done(self, net, iteration, score):
        self.seen.append((iteration, score))


@pytest.mark.parametrize("form", ["multidataset", "iterator", "arrays",
                                  "lists", "tensors"])
def test_fit_takes_every_input_form(form):
    """Each input form makes exactly the steps a DataSet makes (which the
    tests above hold against the JAX package): one batch of 8, then an
    iterator of two batches of 4, with listeners, `epoch` and
    `last_batch_size` as the JAX fit keeps them."""
    conf = ComputationGraphConfiguration.from_json(_small_graph_json())
    ref = ComputationGraph(conf).init(device="cpu")
    net = ComputationGraph(conf).init(device="cpu")
    x, y = _batch(5, n=8)
    ref.fit(DataSet(x, y))
    log = ScoreLog()
    net.set_listeners(log)
    if form == "iterator":
        net.fit(ListDataSetIterator(DataSet(x, y), batch=8))
    elif form == "multidataset":
        net.fit(MultiDataSet([x], [y]))
    elif form == "arrays":
        net.fit(x, y)
    elif form == "lists":
        net.fit([x], [y])
    else:
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        assert net._batch(tx) is tx  # on the network's device: no copy
        net.fit(tx, ty)
        with pytest.raises(TypeError):
            net.fit("not a dataset")
    assert net.score_ == ref.score_
    assert log.seen == [(1, net.score_)] and net.epoch == 1
    assert net.last_batch_size == 8
    ref.fit(ListDataSetIterator(DataSet(x, y), batch=4), epochs=2)
    net.fit(ListDataSetIterator(DataSet(x, y), batch=4), epochs=2)
    assert net.iteration == ref.iteration == 5 and net.epoch == 3
    assert net.last_batch_size == 4 and len(log.seen) == 5
    assert [i for i, _ in log.seen] == [1, 2, 3, 4, 5]
    a, b = net.get_param_table(), ref.get_param_table()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_score_uses_running_stats_and_output_fit_output():
    """score() is the loss with the running statistics (train=False), as
    the JAX package's; output -> fit -> output on one network: inference
    makes no tensor that training then updates."""
    jnet, tnet = _pair(_small_graph_json())
    x, y = _batch(7)
    before = tnet.output(x)
    assert before.is_inference()
    want = jnet.score(jds.DataSet(x, y))
    assert abs(tnet.score(DataSet(x, y)) - want) <= 1e-5 * abs(want)
    np.testing.assert_allclose(before.numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-6)
    jnet.fit(jds.DataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert not any(t.is_inference() for p in tnet.params.values()
                   for t in p.values())
    assert not any(t.is_inference() for s in tnet.state.values()
                   for t in s.values())
    after = tnet.output(x)
    np.testing.assert_allclose(after.numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(after.numpy(), before.numpy())
    want = jnet.score(jds.DataSet(x, y))
    assert abs(tnet.score(DataSet(x, y)) - want) <= 1e-5 * abs(want)
    tnet.fit(DataSet(x, y))
    assert np.isfinite(tnet.score_)


def test_graph_opt_state_round_trips_and_a_jax_run_resumes_in_the_port():
    """2 JAX steps, params, state and Nesterovs slots carried across
    (conv kernels HWIO in the interchange form, OIHW channels_last in the
    port), then one more step in each: the same step. The port's slots
    round-trip unchanged and mismatches are refused."""
    jnet, tnet = _pair(_small_graph_json())
    for step in range(2):
        jnet.fit(jds.DataSet(*_batch(20 + step)))
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    interop.opt_state_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.opt_state))
    assert tnet.opt_state["b0_a_conv"]["v"]["W"].is_contiguous(
        memory_format=torch.channels_last)
    tnet.iteration = jnet.iteration
    x, y = _batch(22)
    jnet.fit(jds.DataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    assert max(_slot_errs(jnet, tnet).values()) <= 1e-4
    out = interop.opt_state_to_jax(tnet)
    assert isinstance(out, dict) and out["b0_add"] == {"v": {}}
    assert out["stem_conv"]["v"]["W"].shape == (7, 7, 3, 8)  # HWIO
    fresh = ComputationGraph(tnet.conf).init(device="cpu")
    interop.opt_state_from_jax(fresh, out)
    again = interop.opt_state_to_jax(fresh)
    for name in out:
        for path, v in flat_items(out[name]["v"]):
            np.testing.assert_array_equal(
                dict(flat_items(again[name]["v"]))[path], v)
    bad = dict(out)
    del bad["out"]
    with pytest.raises(ValueError):
        interop.opt_state_from_jax(fresh, bad)
    bad = {k: {"v": dict(v["v"])} for k, v in out.items()}
    bad["stem_conv"]["v"]["W"] = np.zeros((7, 7, 3, 4), np.float32)
    with pytest.raises(ValueError):
        interop.opt_state_from_jax(fresh, bad)
    with pytest.raises(ValueError):
        interop.opt_state_from_jax(fresh, list(out.values()))


@pytest.mark.parametrize("where", ["dropout", "weight_noise", "solver",
                                   "masks", "tbptt"])
def test_graph_fit_refuses_what_it_does_not_train(where):
    """Each of these trains as the JAX graph does, so fit refuses none of
    them: dropout on a conv vertex, DropConnect on the Output vertex, a
    line-search optimization_algo (the JAX graph has no solver path and
    takes its SGD updater step, as the port's does), a labels mask (one
    row out of the loss) and a tBPTT configuration (whose 2-D labels train
    the whole batch): 3 steps with the JAX graph's keys replayed into the
    port's draws, against the JAX fit."""
    d = json.loads(_small_graph_json())
    if where == "dropout":
        d["vertices"]["b0_a_conv"]["layer"]["dropout"] = 0.9
    elif where == "weight_noise":
        d["vertices"]["out"]["layer"]["weight_noise"] = {
            "type": "DropConnect", "p": 0.5}
    elif where == "solver":
        d["defaults"]["optimization_algo"] = "lbfgs"
    elif where == "tbptt":
        d["defaults"]["backprop_type"] = "tbptt"
    lm = None
    if where == "masks":
        lm = np.ones((4, 1), np.float32)
        lm[1] = 0.0
    jnet, tnet = _pair(json.dumps(d))
    tnet.draws = JaxKeys.for_net(d["defaults"]["seed"])
    for step in range(3):
        x, y = _batch(30 + step)
        jnet.fit(jds.DataSet(x, y, None, lm))
        tnet.fit(DataSet(x, y, None, lm))
        assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(
            jnet.score_), (step, tnet.score_, jnet.score_)
    assert tnet.iteration == jnet.iteration == 3
    if where in ("tbptt", "solver"):
        # the standard step, bit for bit: the same graph without the
        # tBPTT or solver configuration on the same batches (whose params are
        # 1.1e-5 from JAX's after these 3 train-mode steps, ROADMAP
        # C.4; test_small_graph_fit_matches_jax_step_by_step holds
        # that step to JAX)
        _, plain = _pair(_small_graph_json())
        for step in range(3):
            plain.fit(DataSet(*_batch(30 + step)))
        want = plain.get_param_table()
        for k, v in tnet.get_param_table().items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        return
    jt, tt = jnet.get_param_table(), tnet.get_param_table()
    worst = max(float(np.abs(tt[k] - np.asarray(jt[k])).max())
                for k in jt)
    assert worst <= 1e-5, worst
    assert _state_err(jnet, tnet) <= 1e-4
    assert max(_slot_errs(jnet, tnet).values()) <= 1e-4


def test_graph_config_json_matches_jax_and_penalty_skips_biases():
    """The small graph's JSON reads the same in both packages, and the
    graph's penalty counts no bias terms (the JAX ComputationGraph's
    `_reg_score`), even with l2_bias set."""
    conf = _small_graph_json(l2_bias=0.5)
    jconf = JGConf.from_json(conf)
    assert json.loads(jconf.to_json()) == json.loads(conf)
    jnet, tnet = _pair(conf, perturb=False)
    want = float(jnet._reg_score(jnet.params))
    got = float(tnet._reg_score(tnet.params))
    assert abs(got - want) <= 1e-5 * want
