"""LeNet's path against the JAX package: the zoo config, MnistDataSetIterator
(its seeded synthetic sample and its idx reader) and MultiLayerNetwork.fit
of zoo LeNet step by step.

The data directory is a fresh temporary one in every test, so neither
package finds MNIST files it did not write. Tolerances: the iterator's
batches bit for bit; fit, per-step scores 1e-5 relative, params 1e-5
absolute, Adam slots 1e-4 of each leaf's largest magnitude (float32 on both
sides; convolutions and sums in another order).
"""
import gzip
import json

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
from deeplearning4j_tpu_torch.datasets import fetchers as tfetchers
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.zoo import LeNet


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    return tmp_path


def _batches(iterator):
    return [(np.asarray(d.features), np.asarray(d.labels)) for d in iterator]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_lenet_config_json_matches_jax():
    want = json.loads(JLeNet().conf().to_json())
    assert json.loads(LeNet().conf().to_json()) == want
    assert want["input_preprocessors"] == {}
    back = MultiLayerConfiguration.from_json(json.dumps(want))
    assert json.loads(back.to_json()) == want


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mnist_equals_jax_bit_for_bit(data_dir, train):
    """Two epochs (each reshuffled from the seed) of the seeded synthetic
    sample, features in [0, 1] and one-hot labels."""
    kw = dict(batch=100, train=train, seed=5)
    jit_ = jfetchers.MnistDataSetIterator(**kw)
    tit = MnistDataSetIterator(**kw)
    assert tit.synthetic and jit_.synthetic
    for _ in range(2):
        got, want = _batches(tit), _batches(jit_)
        _same_batches(got, want)
    assert got[0][0].shape == (100, 28, 28, 1) and got[0][1].shape == (
        100, 10)
    assert (tit.batch_size(), tit.total_outcomes(), tit.input_columns()) \
        == (100, 10, 784)


def _write_idx(path, arr, gz):
    header = bytes([0, 0, 8, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_read_as_jax_reads_them(data_dir, gz):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (37, 28, 28)).astype(np.uint8)
    ids = rng.integers(0, 10, 37).astype(np.uint8)
    _write_idx(data_dir / "t10k-images-idx3-ubyte", imgs, gz)
    _write_idx(data_dir / "t10k-labels-idx1-ubyte", ids, gz)
    suffix = ".gz" if gz else ""
    path = str(data_dir / "t10k-images-idx3-ubyte") + suffix
    np.testing.assert_array_equal(tfetchers.read_idx(path), imgs)
    np.testing.assert_array_equal(tfetchers.read_idx(path),
                                  jfetchers.read_idx(path))
    kw = dict(batch=16, train=False, num_examples=30, seed=1)
    tit, jit_ = MnistDataSetIterator(**kw), jfetchers.MnistDataSetIterator(
        **kw)
    assert not tit.synthetic and not jit_.synthetic
    _same_batches(_batches(tit), _batches(jit_))
    bad = data_dir / "bad"
    bad.write_bytes(b"\x00\x00\x0d\x01" + (5).to_bytes(4, "big") + b"12345")
    with pytest.raises(ValueError):
        tfetchers.read_idx(str(bad))
    short = data_dir / "short"
    short.write_bytes(b"\x00\x00\x08\x01" + (9).to_bytes(4, "big") + b"12")
    with pytest.raises(ValueError):
        tfetchers.read_idx(str(short))


def test_lenet_fit_on_mnist_matches_jax(data_dir):
    """3 Adam steps of zoo LeNet on MnistDataSetIterator(batch=16) over 48
    synthetic examples, JAX weights carried into the port."""
    jnet = JLeNet().init()
    tnet = LeNet().init(device="cpu")
    interop.params_from_jax(tnet,
                            jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    kw = dict(batch=16, num_examples=48, seed=3)
    seen = []

    class Listener:
        def iteration_done(self, net, iteration, score):
            seen.append(score)

    tnet.set_listeners(Listener())
    jscores = []
    for jb, tb in zip(jfetchers.MnistDataSetIterator(**kw),
                      MnistDataSetIterator(**kw)):
        jnet.fit(jb)
        tnet.fit(tb)
        jscores.append(jnet.score_)
    assert len(seen) == len(jscores) == 3
    for got, want in zip(seen, jscores):
        assert abs(got - want) <= 1e-5 * abs(want), (seen, jscores)
    jt = jnet.get_param_table()
    tt = tnet.get_param_table()
    assert set(tt) == set(jt)
    for k in tt:
        assert np.abs(tt[k] - np.asarray(jt[k])).max() <= 1e-5, k
    for i, (got, want) in enumerate(zip(interop.opt_state_to_jax(tnet),
                                        jnet.opt_state)):
        for slot in ("m", "v"):
            g = dict(flat_items(got[slot]))
            for path, w in jax.tree_util.tree_map(np.asarray,
                                                  want[slot]).items():
                assert np.abs(g[path] - w).max() <= 1e-4 * max(
                    np.abs(w).max(), 1e-30), (i, slot, path)
        # a layer without params (pooling) takes no step
        assert int(got["t"]) == int(want["t"]) == (3 if got["m"] else 0)
