"""The layers keep shapes off the kernels that refuse them, as the JAX
layers do: an unmasked attention call reaches `fa.flash_attention` only for
a head dim in `fa.HEAD_DIMS`, an LSTM reaches the LSTM kernel families
only for n <= `lstm_ops.MAX_N`; every other shape takes sdpa or the
per-step loop. The route depends on the shape alone, so the CPU takes the
card's: here the kernels' wrappers are replaced by functions that raise,
and a head dim of 96 and an LSTM of 1032 units still run, forward and one
training step, and agree with the JAX package, while head dim 64 and 1024
units reach the (raising) wrappers.

Tolerances: outputs 1e-5 of their largest magnitude, scores 1e-5
relative, params after one step 1e-5 absolute (float32 on both sides; sums
in another order).
"""
import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    GravesLSTM,
    RnnOutput,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

LSTM_KERNELS = ("lstm_scan", "lstm_scan_peephole", "lstm_scan_chunked",
                "lstm_scan_chunked_peephole")


class KernelReached(Exception):
    pass


@pytest.fixture
def raising_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise KernelReached

    monkeypatch.setattr(fa, "flash_attention", refuse)
    for name in LSTM_KERNELS:
        monkeypatch.setattr(lstm_ops, name, refuse)


def _conf(kind, width, t=6, f=4, classes=5):
    if kind == "attention":
        hidden = TransformerBlock(n_heads=1, causal=True)
        in_type = it.recurrent(width, t)
    else:
        cls = LSTM if kind == "lstm" else GravesLSTM
        hidden = cls(n_out=width, activation="tanh")
        in_type = it.recurrent(f, t)
    return NeuralNetConfiguration(seed=4, updater="sgd").list([
        hidden, RnnOutput(n_out=classes, loss="mcxent",
                          activation="softmax"),
    ]).set_input_type(in_type)


def _data(conf, b=2):
    rng = np.random.default_rng(3)
    t, f = conf.input_type.timesteps, conf.input_type.size
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (b, t))]
    return x, y


@pytest.mark.parametrize("kind,width", [("attention", 96), ("lstm", 1032),
                                        ("graves", 1032)])
def test_shapes_the_kernels_refuse_run_and_match_jax(raising_kernels, kind,
                                                     width):
    conf = _conf(kind, width)
    jnet = JMLN(JConf.from_json(conf.to_json())).init()
    tnet = MultiLayerNetwork(conf).init(device="cpu")
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    x, y = _data(conf)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    jnet.fit(jds.DataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert abs(tnet.score_ - jnet.score_) <= 1e-5 * abs(jnet.score_)
    jt = dict(flat_items(jax.tree_util.tree_map(np.asarray, jnet.params)))
    tt = tnet.get_param_table()
    assert set(tt) == set(jt)
    for k in tt:
        assert np.abs(tt[k] - jt[k]).max() <= 1e-5, k


@pytest.mark.parametrize("kind,width", [("attention", 64), ("lstm", 1024),
                                        ("graves", 1024)])
def test_shapes_inside_the_kernels_sets_reach_them(raising_kernels, kind,
                                                   width):
    net = MultiLayerNetwork(_conf(kind, width, t=3)).init(device="cpu")
    x, _ = _data(net.conf)
    with pytest.raises(KernelReached):
        net.output(x)
