"""The port's char-RNN path against the JAX package: the fused LSTM scan's
plain version (deeplearning4j_tpu_torch/ops/lstm.py) against the Pallas
kernel run as the JAX tests run it on the CPU (interpret mode) and against
its lax.scan reference, the recurrent layers, zoo TextGenerationLSTM, and
stateful `rnn_time_step` in both runtimes.

Inputs are made with numpy from a seed and handed to both packages; JAX
arrays are float32 (or bfloat16) even with x64 on. Tolerances, relative to
max(1, the largest magnitude of the expected value): float32 1e-5 (sums in
another order, sigmoid/tanh from another library), bfloat16 2e-2 (the
outputs are rounded to bfloat16 from float32 values that differ in their
last bits). Networks: every activation within 1e-5 of its largest
magnitude; stepped against whole-sequence runs 1e-5 absolute on
probabilities.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.nn import inputs as jit_
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNConf
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JCGConf,
)
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JTextGenerationLSTM
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import (
    ComputationGraph,
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.nn import inputs as tit
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.layers.base import Layer as TLayer
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16,
                       2e-2)}


def _err(got, want):
    """max |got - want| / max(1, max |want|)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _scan_inputs(b, t, n, dtype="float32", seed=0, peephole=True,
                 masked=False):
    """zx, R, p, h0, c0, mask as numpy arrays in `dtype` (mask float32,
    with ragged lengths and row 1 fully masked)."""
    rng = np.random.default_rng(seed)
    npd = DTYPES[dtype][0]
    arrs = [rng.standard_normal((b, t, 4 * n)) * 0.5,
            rng.standard_normal((n, 4 * n)) * (1.0 / np.sqrt(n)),
            rng.standard_normal((3, n)) * 0.3 if peephole else None,
            rng.standard_normal((b, n)) * 0.5,
            rng.standard_normal((b, n)) * 0.5]
    arrs = [None if a is None else a.astype(npd) for a in arrs]
    mask = None
    if masked:
        lengths = rng.integers(1, t + 1, b)
        mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
        mask[1] = 0.0
    return (*arrs, mask)


def _t(a, dtype="float32"):
    if a is None:
        return None
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][2])


def _j(a, dtype="float32"):
    return None if a is None else jnp.asarray(a, DTYPES[dtype][1])


# ------------------------------------------------------- the scan itself
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("peephole", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_scan_matches_pallas_interpret(dtype, peephole, masked):
    """b = 3 (no multiple of any block), t = 7, n = 12, nonzero h0/c0."""
    zx, R, p, h0, c0, mask = _scan_inputs(3, 7, 12, dtype, seed=7,
                                          peephole=peephole, masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    jargs = [_j(a, dtype) for a in (zx, R)]
    jcarry = [_j(a, dtype) for a in (h0, c0)]
    if peephole:
        want = pk.lstm_scan_peephole(*jargs, _j(p, dtype), *jcarry, 3, True,
                                     jm)
    else:
        want = pk.lstm_scan(*jargs, *jcarry, 3, True, jm)
    tz, tR, tp, th0, tc0 = (_t(a, dtype) for a in (zx, R, p, h0, c0))
    tm = None if mask is None else torch.from_numpy(mask)
    got = (tlstm.lstm_scan_peephole(tz, tR, tp, th0, tc0, tm) if peephole
           else tlstm.lstm_scan(tz, tR, th0, tc0, tm))
    ref = tlstm.lstm_scan_reference(tz, tR, th0, tc0, tp, tm)
    tol = DTYPES[dtype][3]
    for g, r, w in zip(got, ref, want):
        assert g.dtype == DTYPES[dtype][2]
        assert torch.equal(g, r)  # the CPU tensor took the plain version
        assert _err(g, w) < tol
    if mask is not None:
        # the fully masked row outputs zeros and keeps its carry
        assert not got[0][1].float().abs().any()
        assert torch.equal(got[1][1], th0[1]) and torch.equal(got[2][1],
                                                              tc0[1])


@pytest.mark.parametrize("peephole", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_scan_matches_lax_scan_reference(peephole, masked):
    zx, R, p, h0, c0, mask = _scan_inputs(5, 11, 16, seed=11,
                                          peephole=peephole, masked=masked)
    want = pk._lstm_ref(*(_j(a) for a in (zx, R, h0, c0)), _j(p),
                        None if mask is None else jnp.asarray(mask))
    got = tlstm.lstm_scan_reference(*(_t(a) for a in (zx, R, h0, c0)),
                                    _t(p), None if mask is None
                                    else torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert _err(g, w) < 1e-5


def test_mask_of_any_numeric_dtype_means_greater_than_zero():
    zx, R, p, h0, c0, mask = _scan_inputs(4, 6, 8, masked=True, seed=3)
    args = [_t(a) for a in (zx, R, p, h0, c0)]
    want = tlstm.lstm_scan_peephole(*args, torch.from_numpy(mask))
    for m in (torch.from_numpy(mask).bool(), torch.from_numpy(mask).int(),
              torch.from_numpy(mask * 2 - 1).double()):
        got = tlstm.lstm_scan_peephole(*args, m)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_zero_steps_return_the_carry():
    zx, R, _, h0, c0, _ = _scan_inputs(2, 0, 4, peephole=False)
    hs, hT, cT = tlstm.lstm_scan(*(_t(a) for a in (zx, R, h0, c0)))
    assert hs.shape == (2, 0, 4)
    assert torch.equal(hT, _t(h0)) and torch.equal(cT, _t(c0))


def test_cpu_tensors_never_launch_the_kernel():
    before = tlstm.lstm_scan.launches
    zx, R, p, h0, c0, mask = _scan_inputs(2, 3, 4, masked=True)
    tlstm.lstm_scan_peephole(*(_t(a) for a in (zx, R, p, h0, c0)),
                             torch.from_numpy(mask))
    tlstm.lstm_scan(*(_t(a) for a in (zx, R, h0, c0)))
    net = TextGenerationLSTM(num_classes=5, max_length=3).init(device="cpu")
    net.output(np.eye(5, dtype=np.float32)[None, :3])
    net.rnn_time_step(np.eye(5, dtype=np.float32)[:2])
    assert tlstm.lstm_scan.launches == before


@pytest.mark.parametrize("bad", ["noncontig", "shape", "dtype", "float64",
                                 "rank", "mask_shape"])
def test_scan_refuses_what_it_does_not_take(bad):
    zx, R, p, h0, c0 = (_t(a) for a in _scan_inputs(2, 3, 4)[:5])
    mask = None
    if bad == "noncontig":
        R = torch.from_numpy(np.zeros((16, 4), np.float32)).t()
        assert not R.is_contiguous()
    elif bad == "shape":
        h0 = h0[:1]
    elif bad == "dtype":
        p = p.double()
    elif bad == "float64":
        zx, R, p, h0, c0 = (a.double() for a in (zx, R, p, h0, c0))
    elif bad == "rank":
        zx = zx[0]
    else:
        mask = torch.ones(2, 4)
    with pytest.raises((TypeError, ValueError)):
        tlstm.lstm_scan_peephole(zx, R, p, h0, c0, mask)


def test_scan_backward_matches_jax_vjp():
    """The scan's backward (the fused backward's plain version on the CPU)
    runs and equals `jax.vjp` of the Pallas scan (interpret mode) to 1e-5
    of each gradient's largest magnitude."""
    zx, R, p, h0, c0, _ = _scan_inputs(2, 3, 4)
    args = [_t(a).requires_grad_() for a in (zx, R, p, h0, c0)]
    hs, hT, cT = tlstm.lstm_scan_peephole(*args)
    assert hs.requires_grad
    (hs.sum() + (cT * cT).sum()).backward()
    jargs = [jnp.asarray(a) for a in (zx, R, p, h0, c0)]
    (jhs, jhT, jcT), vjp = jax.vjp(
        lambda *a: pk.lstm_scan_peephole(*a, 8, True), *jargs)
    want = vjp((jnp.ones_like(jhs), jnp.zeros_like(jhT), 2 * jcT))
    for a, w in zip(args, want):
        assert a.grad is not None and _err(a.grad, w) < 1e-5


# --------------------------------------------------------------- layers
def _perturbed(params, rng):
    """Random peepholes and biases (zeros would hide a dropped term)."""
    out = dict(params)
    for k in ("b", "pi", "pf", "po"):
        if k in out:
            out[k] = (rng.standard_normal(out[k].shape) * 0.5).astype(
                np.float32)
    return out


def _layer_pair(jlayer, n_in, seed=0):
    jp = jlayer.init_params(jax.random.PRNGKey(seed),
                            jit_.recurrent(n_in, 5))
    params = _perturbed(jax.tree_util.tree_map(np.asarray, jp),
                        np.random.default_rng(seed))
    tlayer = TLayer.from_json(json.loads(json.dumps(jlayer.to_json())))
    assert type(tlayer).__name__ == type(jlayer).__name__
    assert tlayer.to_json() == jlayer.to_json()
    return (jax.tree_util.tree_map(jnp.asarray, params), tlayer,
            interop.layer_params_from_jax(tlayer, params))


@pytest.mark.parametrize("cls", ["LSTM", "GravesLSTM"])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_apply_and_scan_match_jax(cls, masked):
    jlayer = getattr(jlayers, cls)(n_out=12, activation="tanh")
    jparams, tlayer, tparams = _layer_pair(jlayer, 6, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 9, 6)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 9), np.float32)
        mask[0, 5:] = 0.0
        mask[2] = 0.0
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want, _ = jlayer.apply(jparams, jnp.asarray(x), state={}, train=False,
                           rng=None, mask=jm)
    got, _ = tlayer.apply(tparams, torch.from_numpy(x), state={},
                          train=False, mask=tm)
    assert got.shape == (3, 9, 12) and _err(got, want) < 1e-5
    carry = [rng.standard_normal((3, 12)).astype(np.float32) * 0.5
             for _ in range(2)]
    jy, (jh, jc) = jlayer.scan(jparams, jnp.asarray(x),
                               tuple(jnp.asarray(c) for c in carry), mask=jm)
    ty, (th, tc) = tlayer.scan(tparams, torch.from_numpy(x),
                               tuple(torch.from_numpy(c) for c in carry),
                               mask=tm)
    for g, w in ((ty, jy), (th, jh), (tc, jc)):
        assert _err(g, w) < 1e-5


@pytest.fixture
def no_kernel_entry(monkeypatch):
    """The layer must not reach the fused-scan entry points."""
    def refuse(*a, **kw):
        raise AssertionError("the fused scan was called")

    monkeypatch.setattr(trec.lstm_ops, "lstm_scan", refuse)
    monkeypatch.setattr(trec.lstm_ops, "lstm_scan_peephole", refuse)


@pytest.mark.parametrize("masked", [False, True])
def test_hardsigmoid_cell_takes_the_plain_loop_like_jax(no_kernel_entry,
                                                        masked):
    jlayer = jlayers.GravesLSTM(n_out=8, activation="tanh",
                                gate_activation="hardsigmoid")
    jparams, tlayer, tparams = _layer_pair(jlayer, 5, seed=8)
    x = np.random.default_rng(9).standard_normal((2, 7, 5)).astype(
        np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 3:] = 0.0
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want, _ = jlayer.apply(jparams, jnp.asarray(x), state={}, train=False,
                           rng=None, mask=jm)
    got, _ = tlayer.apply(tparams, torch.from_numpy(x), state={},
                          train=False, mask=tm)
    assert _err(got, want) < 1e-5


def test_float64_cell_takes_the_plain_loop_like_jax(no_kernel_entry):
    jlayer = jlayers.GravesLSTM(n_out=8, activation="tanh")
    jparams, tlayer, _ = _layer_pair(jlayer, 5, seed=10)
    p64 = {k: np.asarray(v, np.float64) for k, v in jparams.items()}
    x = np.random.default_rng(11).standard_normal((2, 6, 5))
    want, _ = jlayer.apply({k: jnp.asarray(v) for k, v in p64.items()},
                           jnp.asarray(x), state={}, train=False, rng=None)
    got, _ = tlayer.apply({k: torch.from_numpy(v) for k, v in p64.items()},
                          torch.from_numpy(x), state={}, train=False)
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_graves_lstm_params_cross_unchanged_and_init_like_jax():
    jlayer = jlayers.GravesLSTM(n_out=6, activation="tanh",
                                forget_gate_bias_init=0.7)
    jparams, tlayer, tparams = _layer_pair(jlayer, 4)
    assert set(tparams) == set(jparams) == {"W", "R", "b", "pi", "pf", "po"}
    for k in jparams:
        np.testing.assert_array_equal(tparams[k].numpy(),
                                      np.asarray(jparams[k]))
    fresh = tlayer.init_params(torch.Generator().manual_seed(0),
                               tit.recurrent(4, 5))
    jfresh = jlayer.init_params(jax.random.PRNGKey(0),
                                jit_.recurrent(4, 5))
    assert list(fresh) == list(jfresh) == ["W", "R", "b", "pi", "pf", "po"]
    for k in jfresh:
        assert tuple(fresh[k].shape) == jfresh[k].shape
    np.testing.assert_array_equal(fresh["b"].numpy(), np.asarray(jfresh["b"]))
    for k in ("pi", "pf", "po"):
        assert not fresh[k].any()


def test_streaming_refuses_a_layer_that_is_not_streamable(monkeypatch):
    net = TextGenerationLSTM(num_classes=5, max_length=3).init(device="cpu")
    monkeypatch.setattr(type(net.layers[0]), "streamable", False)
    with pytest.raises(ValueError, match="bidirectional"):
        net.rnn_time_step(np.zeros((1, 5), np.float32))
    assert net._init_carries(2)[0][0].shape == (2, 256)


# --------------------------------------------------------------- networks
def _zoo_confs(vocab, t, n):
    """The zoo TextGenerationLSTM config of both packages, its GravesLSTM
    width cut to n."""
    jconf = JTextGenerationLSTM(num_classes=vocab, max_length=t,
                                seed=3).conf()
    tconf = TextGenerationLSTM(num_classes=vocab, max_length=t,
                               seed=3).conf()
    for conf in (jconf, tconf):
        for layer in conf.layers[:2]:
            layer.n_out = n
    return jconf, tconf


def _net_pair(vocab=11, t=9, n=16):
    jconf, tconf = _zoo_confs(vocab, t, n)
    jnet = JMultiLayerNetwork(jconf).init()
    rng = np.random.default_rng(2026)
    params = {k: _perturbed(jax.tree_util.tree_map(np.asarray, v), rng)
              for k, v in jnet.params.items()}
    state = jax.tree_util.tree_map(np.asarray, jnet.state)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = MultiLayerNetwork(tconf).init(device="cpu")
    interop.params_from_jax(tnet, params, state)
    return jnet, tnet


def _one_hot(b, t, vocab, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, t))
    return np.eye(vocab, dtype=np.float32)[ids]


@pytest.fixture(scope="module")
def nets():
    return _net_pair()


def test_param_tables_are_identical(nets):
    jnet, tnet = nets
    jt, tt = jnet.get_param_table(), tnet.get_param_table()
    assert list(tt) == list(jt)
    assert "layer_1/po" in tt and tt["layer_1/R"].shape == (16, 64)
    for k in jt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)


@pytest.mark.parametrize("n", [16, 256])
def test_text_generation_lstm_output_matches_jax(nets, n):
    jnet, tnet = nets if n == 16 else _net_pair(n=n)
    x = _one_hot(3, 9, 11, seed=1)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x)
    assert got.shape == (3, 9, 11) and got.device.type == "cpu"
    assert _err(got, want) < 1e-5
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    for i, (g, w) in enumerate(zip(tnet.feed_forward(x),
                                   jnet.feed_forward(x))):
        assert _err(g, w) < 1e-5, i


def test_mln_rnn_time_step_matches_jax_and_output(nets):
    jnet, tnet = nets
    x = _one_hot(4, 9, 11, seed=2)
    full = tnet.output(x).numpy()
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()
    jsteps, tsteps = [], []
    for s in range(9):
        jsteps.append(np.asarray(jnet.rnn_time_step(x[:, s])))
        got = tnet.rnn_time_step(x[:, s])
        assert got.shape == (4, 11) and isinstance(got, torch.Tensor)
        tsteps.append(got.numpy())
    stepped = np.stack(tsteps, axis=1)
    assert _err(stepped, np.stack(jsteps, axis=1)) < 1e-5
    np.testing.assert_allclose(stepped, full, rtol=0, atol=1e-5)
    # in chunks of 4, 3 and 2 steps
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()
    chunks = [tnet.rnn_time_step(x[:, a:b]).numpy()
              for a, b in ((0, 4), (4, 7), (7, 9))]
    jchunks = [np.asarray(jnet.rnn_time_step(x[:, a:b]))
               for a, b in ((0, 4), (4, 7), (7, 9))]
    chunked = np.concatenate(chunks, axis=1)
    assert _err(chunked, np.concatenate(jchunks, axis=1)) < 1e-5
    np.testing.assert_allclose(chunked, full, rtol=0, atol=1e-5)
    # clearing the state restarts the stream
    tnet.rnn_clear_previous_state()
    np.testing.assert_array_equal(tnet.rnn_time_step(x[:, 0]).numpy(),
                                  tsteps[0])


def test_mln_rnn_time_step_keeps_its_state_after_a_failed_call(nets):
    _, tnet = nets
    x = _one_hot(2, 3, 11, seed=4)
    tnet.rnn_clear_previous_state()
    tnet.rnn_time_step(x[:, 0])
    kept = tnet._rnn_carries
    with pytest.raises((RuntimeError, ValueError)):
        tnet.rnn_time_step(x[:1, 1])  # another batch size
    assert tnet._rnn_carries is kept
    np.testing.assert_allclose(
        tnet.rnn_time_step(x[:, 1]).numpy(),
        tnet.output(x[:, :2])[:, 1].numpy(), rtol=0, atol=1e-5)


def _cg_confs():
    def build(nnconf, cgconf, layers, inputs):
        return (cgconf(defaults=nnconf(seed=5)).add_inputs("in")
                .add_layer("lstm", layers.GravesLSTM(n_out=10,
                                                     activation="tanh"),
                           "in")
                .add_layer("out", layers.RnnOutput(n_out=4, loss="mcxent"),
                           "lstm")
                .set_outputs("out")
                .set_input_types(inputs.recurrent(3, 6)))

    from deeplearning4j_tpu_torch.nn import layers as tlayers
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    return (build(JNNConf, JCGConf, jlayers, jit_),
            build(NeuralNetConfiguration, ComputationGraphConfiguration,
                  tlayers, tit))


def test_cg_rnn_time_step_matches_full_sequence_and_jax():
    jconf, tconf = _cg_confs()
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    jnet = JComputationGraph(jconf).init()
    rng = np.random.default_rng(0)
    params = {k: _perturbed(jax.tree_util.tree_map(np.asarray, v), rng)
              for k, v in jnet.params.items()}
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = ComputationGraph(tconf).init(device="cpu")
    interop.params_from_jax(tnet, params,
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    x = rng.standard_normal((2, 6, 3), dtype=np.float32)
    full = np.asarray(jnet.output(x))
    assert _err(tnet.output(x), full) < 1e-5
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()
    steps = [tnet.rnn_time_step(x[:, t]).numpy() for t in range(6)]
    jsteps = [np.asarray(jnet.rnn_time_step(x[:, t])) for t in range(6)]
    assert _err(np.stack(steps, 1), np.stack(jsteps, 1)) < 1e-5
    np.testing.assert_allclose(np.stack(steps, axis=1), full, atol=1e-5)
    # clearing state restarts the stream
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, 0]).numpy(),
                               steps[0], atol=1e-6)
    assert tnet._recurrent_vertices() == ["lstm"]


def test_configs_round_trip_both_ways():
    jconf = JTextGenerationLSTM(num_classes=77, max_length=64).conf()
    tconf = TextGenerationLSTM(num_classes=77, max_length=64).conf()
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert [type(l).__name__ for l in back.layers] == [
        "GravesLSTM", "GravesLSTM", "RnnOutput"]
    assert back.defaults.updater.to_json()["type"] == "RmsProp"
    assert back.defaults.l2 == 1e-4
    jback = type(jconf).from_json(tconf.to_json())
    assert json.loads(jback.to_json()) == json.loads(tconf.to_json())
    layer = jlayers.LSTM(n_in=3, n_out=5, gate_activation="hardsigmoid",
                         forget_gate_bias_init=0.5)
    tl = TLayer.from_json(layer.to_json())
    assert isinstance(tl, trec.LSTM) and not isinstance(tl, trec.GravesLSTM)
    assert tl.to_json() == layer.to_json()
    assert jlayers.Layer.from_json(tl.to_json()).to_json() == layer.to_json()


def test_zoo_text_generation_lstm_is_the_served_configuration():
    net = TextGenerationLSTM(num_classes=77, max_length=64, seed=7).init(
        device="cpu")
    shapes = {k: tuple(v.shape) for k, v in net.params["layer_0"].items()}
    assert shapes == {"W": (77, 1024), "R": (256, 1024), "b": (1024,),
                      "pi": (256,), "pf": (256,), "po": (256,)}
    assert net.params["layer_1"]["W"].shape == (256, 1024)
    assert net.params["layer_2"]["W"].shape == (256, 77)
    b = net.params["layer_0"]["b"]
    assert torch.all(b[256:512] == 1) and not b[:256].any()
    again = TextGenerationLSTM(num_classes=77, max_length=64, seed=7).init(
        device="cpu")
    for k, v in net.get_param_table().items():
        np.testing.assert_array_equal(v, again.get_param_table()[k])
