"""The recurrent-training slice against the JAX package: MultiLayerNetwork.fit
of a small two-layer GravesLSTM char-RNN (the zoo TextGenerationLSTM with its
width cut to n = 16, 11 classes, RmsProp(1e-2), l2 1e-4) step by step, by
standard BPTT and by truncated BPTT, with masks, on the chunked route, under
mixed precision, and resumed from a JAX run.

Weights are made by the JAX package and carried into the port with
`interop.params_from_jax`, their peepholes and biases made nonzero first;
one-hot characters and next-character labels are made with numpy from a
seed. Tolerances (float32 on both sides): per-step scores 1e-5 relative;
params 1e-5 absolute and RmsProp's g2 slots 1e-4 of each leaf's largest
magnitude (sums in another order; RmsProp divides each gradient element by
its own running size, so a step moves an element by up to lr / sqrt(1 -
decay) = 0.045, and a difference in the gradient's last bits moves the
element's change by that factor more than the gradient). Mixed precision:
see its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu.datasets import dataset as jds_mod
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import TrainingListener
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JTextGenerationLSTM
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

VOCAB, N = 11, 16


def _confs(t, n=N, tbptt=None):
    """The zoo TextGenerationLSTM config of both packages, its GravesLSTM
    width cut to n, with tBPTT windows of `tbptt` steps when given."""
    jconf = JTextGenerationLSTM(num_classes=VOCAB, max_length=t,
                                seed=3).conf()
    tconf = TextGenerationLSTM(num_classes=VOCAB, max_length=t,
                               seed=3).conf()
    for conf in (jconf, tconf):
        for layer in conf.layers[:2]:
            layer.n_out = n
        if tbptt:
            conf.defaults.backprop_type = "tbptt"
            conf.defaults.tbptt_fwd_length = tbptt
    return jconf, tconf


def _pair(t, n=N, tbptt=None):
    jconf, tconf = _confs(t, n, tbptt)
    jnet = JMLN(jconf).init()
    rng = np.random.default_rng(2026)
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    for k in ("layer_0", "layer_1"):
        for name in ("b", "pi", "pf", "po"):
            params[k][name] = (rng.standard_normal(params[k][name].shape)
                               * 0.3).astype(np.float32)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = MultiLayerNetwork(tconf).init(device="cpu")
    interop.params_from_jax(tnet, params,
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _batch(b, t, seed):
    """b x t one-hot characters and their next characters, one-hot."""
    ids = np.random.default_rng(seed).integers(0, VOCAB, (b, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :t]], eye[ids[:, 1:]]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tables(jnet, tnet):
    jt = {k: np.asarray(v) for k, v in jnet.get_param_table().items()}
    tt = tnet.get_param_table()
    assert list(tt) == list(jt)
    return jt, tt


def _slots(jnet, tnet):
    """[(path, port slot, JAX slot)] of every RmsProp g2 leaf."""
    out = []
    for i, (got, want) in enumerate(zip(interop.opt_state_to_jax(tnet),
                                        jnet.opt_state)):
        assert set(got) == set(want) == {"g2"}, (got.keys(), want.keys())
        assert set(got["g2"]) == set(want["g2"])
        out += [(f"layer_{i}/{k}", got["g2"][k], np.asarray(want["g2"][k]))
                for k in want["g2"]]
    return out


def _compare(jnet, tnet, param_tol=1e-5, slot_tol=1e-4):
    jt, tt = _tables(jnet, tnet)
    for k in jt:
        assert np.abs(tt[k] - jt[k]).max() <= param_tol, (
            k, np.abs(tt[k] - jt[k]).max())
    for path, got, want in _slots(jnet, tnet):
        assert _rel(got, want) <= slot_tol, (path, _rel(got, want))
    assert tnet.iteration == jnet.iteration


def _score_ok(tnet, jnet, tol=1e-5):
    assert abs(tnet.score_ - jnet.score_) <= tol * abs(jnet.score_), (
        tnet.score_, jnet.score_)


# ------------------------------------------------------------------ BPTT
@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_bptt_fit_matches_jax_step_by_step(monkeypatch, route):
    """3 RmsProp steps on 3 batches of 8 x 12. With "pallas" the JAX
    network runs its fused LSTM kernels forward and backward in interpret
    mode (b = 8 admits its kernel backward); with "xla" its lax.scan. The
    port takes the plain versions of rows 5 and 6 either way."""
    if route == "pallas":
        monkeypatch.setenv("DL4J_TPU_PALLAS", "1")
        monkeypatch.setenv("DL4J_TPU_PALLAS_LSTM", "1")
    jnet, tnet = _pair(12)
    for step in range(3):
        x, y = _batch(8, 12, step)
        jnet.fit(jds_mod.DataSet(x, y))
        tnet.fit(DataSet(x, y))
        _score_ok(tnet, jnet)
        assert tnet.last_batch_size == jnet.last_batch_size == 8
    _compare(jnet, tnet)


def test_bptt_fit_with_features_and_labels_masks_matches_jax():
    jnet, tnet = _pair(10)
    rng = np.random.default_rng(7)
    for step in range(2):
        x, y = _batch(6, 10, 10 + step)
        fm = (np.arange(10)[None] < rng.integers(1, 11, 6)[:, None]).astype(
            np.float32)
        fm[2] = 0.0
        lm = fm.copy()
        lm[0, :3] = 0.0
        jnet.fit(jds_mod.DataSet(x, y, fm, lm))
        tnet.fit(DataSet(x, y, fm, lm))
        _score_ok(tnet, jnet)
    _compare(jnet, tnet)


# ------------------------------------------------------------------ tBPTT
class _Recorder(TrainingListener):
    """Per listener call: (iteration, score, param table, g2 slots)."""

    def __init__(self, jax_side):
        self.jax_side = jax_side
        self.calls = []

    def iteration_done(self, net, iteration, score):
        if self.jax_side:
            table = {k: np.array(v) for k, v in net.get_param_table().items()}
            slots = [{k: np.array(v) for k, v in s["g2"].items()}
                     for s in net.opt_state]
        else:
            table = net.get_param_table()
            slots = [{k: np.array(v) for k, v in s["g2"].items()}
                     for s in interop.opt_state_to_jax(net)]
        self.calls.append((iteration, score, table, slots))


@pytest.mark.parametrize("masked", [False, True])
def test_tbptt_fit_matches_jax_window_by_window(masked):
    """t = 20 in windows of 5: 4 iterations per batch, 2 batches. Each
    window's score, iteration, listener call, params and RmsProp slots
    against the JAX package's; the carries restart at zero with each
    batch and pass from window to window detached."""
    jnet, tnet = _pair(20, tbptt=5)
    jrec, trec = _Recorder(True), _Recorder(False)
    jnet.set_listeners(jrec)
    tnet.set_listeners(trec)
    rng = np.random.default_rng(8)
    for step in range(2):
        x, y = _batch(4, 20, 20 + step)
        fm = lm = None
        if masked:
            fm = (np.arange(20)[None] < rng.integers(3, 21, 4)[:, None]
                  ).astype(np.float32)
            lm = fm.copy()
        jnet.fit(jds_mod.DataSet(x, y, fm, lm))
        tnet.fit(DataSet(x, y, fm, lm))
    assert [c[0] for c in trec.calls] == [c[0] for c in jrec.calls] == \
        list(range(1, 9))
    assert tnet.iteration == jnet.iteration == 8
    for (it, ts, tt, tslots), (_, js, jt, jslots) in zip(trec.calls,
                                                         jrec.calls):
        assert abs(ts - js) <= 1e-5 * abs(js), (it, ts, js)
        for k in jt:
            assert np.abs(tt[k] - jt[k]).max() <= 1e-5, (it, k)
        for got, want in zip(tslots, jslots):
            for k in want:
                assert _rel(got[k], want[k]) <= 1e-4, (it, k)
    assert tnet.last_batch_size == jnet.last_batch_size == 4


def test_tbptt_window_carries_reach_the_next_window():
    """The second window starts from the first window's carries: the same
    window fed from zero carries scores differently."""
    _, tnet = _pair(10, tbptt=5)
    _, fresh = _pair(10, tbptt=5)
    x, y = _batch(3, 10, 30)
    scores = []
    tnet.set_listeners(type("L", (), {"iteration_done": lambda s, n, i, sc:
                                      scores.append(sc)})())
    tnet.fit(DataSet(x, y))
    fresh.fit(DataSet(x[:, :5], y[:, :5]))  # the first window alone
    assert scores[0] == pytest.approx(fresh.score_, rel=1e-6)
    fresh.fit(DataSet(x[:, 5:], y[:, 5:]))  # the second, from zero carries
    assert abs(fresh.score_ - scores[1]) > 1e-4 * abs(scores[1])


# ------------------------------------------------------- long sequences
def test_regime_shape_trains_through_the_chunked_route(monkeypatch):
    """b = 2, t = 1024, n = 128: inside the regime, so the port runs rows 7
    and 8 (their plain versions here); against the JAX package's lax.scan
    with its LSTM helper off, 2 steps."""
    monkeypatch.setenv("DL4J_TPU_PALLAS_LSTM", "0")
    calls = []
    real = tlstm.lstm_scan_chunked_forward

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tlstm, "lstm_scan_chunked_forward", spy)
    jnet, tnet = _pair(1024, n=128)
    for step in range(2):
        x, y = _batch(2, 1024, 40 + step)
        jnet.fit(jds_mod.DataSet(x, y))
        tnet.fit(DataSet(x, y))
        _score_ok(tnet, jnet)
    assert len(calls) == 4 and calls[0] == (2, 1024, 512)
    _compare(jnet, tnet)


# ------------------------------------------------------ mixed precision
def test_mixed_precision_fit_matches_jax(monkeypatch):
    """3 RmsProp steps under bf16 activations in both packages, the JAX
    side on its fused kernels (interpret mode), which like the port's keep
    h, c and the gates in float32 and round only their outputs; bf16 is
    rounded at other places all the same. Held as a whole per leaf: the L2
    norm of the port's change from the start minus JAX's within 0.1 of
    JAX's (measured worst 0.033 over three seeds), scores 1e-3 relative
    (5.1e-5), g2 slots 0.1 of each leaf's largest magnitude (0.064: g2
    squares the gradient's bf16 error, largest on the output bias)."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "1")
    monkeypatch.setenv("DL4J_TPU_PALLAS_LSTM", "1")
    jnet, tnet = _pair(12)
    start = {k: v.copy() for k, v in tnet.get_param_table().items()}
    with jdtypes.mixed(), tdtypes.mixed():
        for step in range(3):
            x, y = _batch(8, 12, 50 + step)
            jnet.fit(jds_mod.DataSet(x, y))
            tnet.fit(DataSet(x, y))
            _score_ok(tnet, jnet, tol=1e-3)
    jt, tt = _tables(jnet, tnet)
    for k in jt:
        assert tt[k].dtype == np.float32
        want, got = jt[k] - start[k], tt[k] - start[k]
        assert np.linalg.norm(want) > 0, k
        assert np.linalg.norm(got - want) <= 0.1 * np.linalg.norm(want), (
            k, np.linalg.norm(got - want) / np.linalg.norm(want))
    for path, got, want in _slots(jnet, tnet):
        assert _rel(got, want) <= 0.1, (path, _rel(got, want))


# ---------------------------------------------------------------- resume
def test_jax_run_resumes_in_the_port():
    """2 steps in JAX; params and RmsProp slots carried across both ways;
    then one more step in each: the same step."""
    jnet, tnet = _pair(12)
    for step in range(2):
        jnet.fit(jds_mod.DataSet(*_batch(8, 12, 60 + step)))
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    interop.opt_state_from_jax(tnet, jax.tree_util.tree_map(np.asarray,
                                                            jnet.opt_state))
    tnet.iteration = jnet.iteration
    for path, got, want in _slots(jnet, tnet):
        np.testing.assert_array_equal(got, want, err_msg=path)
    x, y = _batch(8, 12, 62)
    jnet.fit(jds_mod.DataSet(x, y))
    tnet.fit(DataSet(x, y))
    _score_ok(tnet, jnet)
    _compare(jnet, tnet)


def test_zoo_text_generation_lstm_takes_any_length():
    net = TextGenerationLSTM(num_classes=5, max_length=4, seed=1).init(
        device="cpu")
    x, _ = _batch(2, 9, 70)
    out = net.output(x[..., :5])
    assert out.shape == (2, 9, 5)


def test_param_table_is_a_snapshot_that_fit_leaves_alone():
    """fit updates the params in place; a table taken before keeps its
    values, as the JAX package's (immutable arrays) does."""
    _, tnet = _pair(6)
    before = tnet.get_param_table()
    kept = {k: v.copy() for k, v in before.items()}
    tnet.fit(DataSet(*_batch(2, 6, 80)))
    after = tnet.get_param_table()
    for k in kept:
        np.testing.assert_array_equal(before[k], kept[k], err_msg=k)
    assert any(not np.array_equal(after[k], kept[k]) for k in kept)
