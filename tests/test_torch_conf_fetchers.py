"""The configuration surface of ROADMAP A.2 in the port against the JAX
package: the fluent NeuralNetConfigurationBuilder, the DL4J-style aliases
of MultiLayerConfiguration, the precision policy's `set_bf16_matmuls` /
`policy_fingerprint`, and the built-in dataset fetchers.

Exactness: configuration JSON equal as text; every fetcher's synthetic
sample and every batch of two epochs equal to the JAX package's bit for
bit (features, labels, shuffling), and so are the readers on small files
written to tmp_path (EMNIST idx, CIFAR-10 binary batches, SVHN .mat, LFW
and TinyImageNet image trees, iris CSV, UCI text).
"""
import os
import sys

import numpy as np
import pytest

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu import native
from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.nn import inputs as tit
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    NeuralNetConfigurationBuilder,
)


# ---------------------------------------------------------------- builder
def _built(nnc, upd, layers, inputs):
    return (nnc.builder().seed(12.0).updater(upd(learning_rate=3e-3))
            .l2(1e-4).weight_init("relu").activation("relu")
            .iterations(5).use_drop_connect(True).mini_batch()
            .gradient_normalization("clip_l2_per_layer")
            .list([layers.Dense(n_out=16), layers.Output(n_out=3,
                                                         loss="mcxent")])
            .setInputType(inputs.feed_forward(6)).backprop(True)
            .pretrain(False))


def test_builder_conf_json_equals_jaxs():
    """The fluent builder with setters, the legacy no-ops (iterations,
    use_drop_connect), a bare setter (True), seed and updater, list and
    the DL4J aliases: the same configuration JSON in both packages; build
    gives the NeuralNetConfiguration, whose JSON the port reads back."""
    want = _built(JNNC, jupd.Adam, jl, jit)
    got = _built(NeuralNetConfiguration, tupd.Adam, tl, tit)
    assert isinstance(got, MultiLayerConfiguration)
    assert got.to_json() == want.to_json()
    assert got.defaults.seed == 12 and got.defaults.mini_batch is True
    assert '"iterations":' not in got.to_json()
    conf = NeuralNetConfigurationBuilder().seed(3).updater("adam").build()
    assert isinstance(conf, NeuralNetConfiguration)
    assert conf.to_json() == JNNC.builder().seed(3).updater("adam") \
        .build().to_json()
    assert MultiLayerConfiguration.from_json(got.to_json()).to_json() == \
        got.to_json()


def test_builder_refuses_an_unknown_field_as_jax_does():
    for nnc in (JNNC, NeuralNetConfiguration):
        with pytest.raises(TypeError, match="no_such_field"):
            nnc.builder().no_such_field(1).build()


# ------------------------------------------------------------ dtype policy
def test_bf16_matmuls_and_policy_fingerprint_behave_as_jaxs():
    """set_bf16_matmuls and set_mixed_precision in the same sequence give
    the same fingerprints, precision dtypes and mixed flags in both
    packages; full_precision() shows in the fingerprint; the defaults come
    back."""
    start = (jdtypes.policy_fingerprint(), tdtypes.policy_fingerprint())
    assert start[0] == start[1] == (False, True)
    try:
        for bf16, mixed in ((False, False), (False, True), (True, True),
                            (True, False)):
            for mod in (jdtypes, tdtypes):
                mod.set_bf16_matmuls(bf16)
                mod.set_mixed_precision(mixed)
            assert tdtypes.policy_fingerprint() == \
                jdtypes.policy_fingerprint() == (mixed, bf16)
            assert tdtypes.mixed_precision() == jdtypes.mixed_precision()
            assert (tdtypes.matmul_precision_dtype() is None) == \
                (jdtypes.matmul_precision_dtype() is None) == (not bf16)
            with jdtypes.full_precision(), tdtypes.full_precision():
                assert tdtypes.policy_fingerprint() == \
                    jdtypes.policy_fingerprint() == (mixed, False)
            assert tdtypes.policy_fingerprint() == (mixed, bf16)
    finally:
        for mod in (jdtypes, tdtypes):
            mod.set_bf16_matmuls(True)
            mod.set_mixed_precision(False)
    assert tdtypes.policy_fingerprint() == jdtypes.policy_fingerprint() == \
        start[0]


# --------------------------------------------------------------- fetchers
def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([(np.asarray(ds.features), np.asarray(ds.labels))
                    for ds in it])
    return out


def _same_iterators(tit_, jit_):
    assert getattr(tit_, "synthetic", None) == \
        getattr(jit_, "synthetic", None)
    assert tit_.batch_size() == jit_.batch_size()
    assert tit_.total_outcomes() == jit_.total_outcomes()
    assert tit_.input_columns() == jit_.input_columns()
    te, je = _epochs(tit_), _epochs(jit_)
    assert [len(e) for e in te] == [len(e) for e in je]
    for tb, jb in zip(te, je):
        for (tx, ty), (jx, jy) in zip(tb, jb):
            assert tx.dtype == jx.dtype == np.float32
            assert tx.shape == jx.shape
            assert np.array_equal(tx, jx)
            assert np.array_equal(ty, jy)
    return te


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    return tmp_path


SYNTHETIC = {
    "Emnist": lambda m: m.EmnistDataSetIterator(batch=48, num_examples=100,
                                                seed=3),
    "Emnist-test": lambda m: m.EmnistDataSetIterator(batch=64, train=False),
    "Iris": lambda m: m.IrisDataSetIterator(batch=40, seed=5),
    "Cifar": lambda m: m.CifarDataSetIterator(batch=50, num_examples=120),
    "Cifar-test": lambda m: m.CifarDataSetIterator(batch=100, train=False),
    "Svhn": lambda m: m.SvhnDataSetIterator(batch=30, num_examples=70,
                                            seed=9),
    "Svhn-test": lambda m: m.SvhnDataSetIterator(train=False,
                                                 shuffle=False),
    "Lfw": lambda m: m.LfwDataSetIterator(batch=16, num_examples=40,
                                          num_labels=7),
    "TinyImageNet": lambda m: m.TinyImageNetDataSetIterator(
        batch=32, num_examples=64),
    "Uci": lambda m: m.UciSequenceDataSetIterator(batch=64, seed=11),
    "Uci-test": lambda m: m.UciSequenceDataSetIterator(train=False),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_sample_equals_jaxs(data_dir, name):
    """With no files in the data directory each fetcher makes the JAX
    package's seeded sample, bit for bit, batch for batch over two
    epochs."""
    (data_dir / "lfw").mkdir()  # an empty tree falls back too
    t = SYNTHETIC[name](tf)
    assert getattr(t, "synthetic", True)  # Iris has no flag
    _same_iterators(t, SYNTHETIC[name](jf))


def test_u8_to_unit_is_the_native_conversion():
    px = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = native.u8_to_f32(px)
    assert want is not None
    assert np.array_equal(tf.u8_to_unit(px), want)


def _idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    head = bytes([0, 0, 8, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    path.write_bytes(head + arr.tobytes())


def test_emnist_idx_files_read_as_jax(data_dir):
    rng = np.random.default_rng(1)
    _idx(data_dir / "emnist-letters-train-images-idx3-ubyte",
         rng.integers(0, 256, (37, 28, 28)))
    _idx(data_dir / "emnist-letters-train-labels-idx1-ubyte",
         rng.integers(0, 26, 37))
    t = tf.EmnistDataSetIterator(batch=10, num_examples=33, seed=4)
    assert not t.synthetic
    _same_iterators(t, jf.EmnistDataSetIterator(batch=10, num_examples=33,
                                                seed=4))


def _cifar_records(rng, n):
    rec = rng.integers(0, 256, (n, 3073)).astype(np.uint8)
    rec[:, 0] = rng.integers(0, 10, n)
    return rec.tobytes()


@pytest.mark.parametrize("train", [True, False])
def test_cifar_binary_batches_read_as_jax(data_dir, train):
    """data_batch_1.bin at the top, data_batch_3.bin (gzipped) under
    cifar-10-batches-bin/, test_batch.bin for the test split."""
    import gzip

    rng = np.random.default_rng(2)
    (data_dir / "data_batch_1.bin").write_bytes(_cifar_records(rng, 5))
    sub = data_dir / "cifar-10-batches-bin"
    sub.mkdir()
    with gzip.open(sub / "data_batch_3.bin.gz", "wb") as f:
        f.write(_cifar_records(rng, 4))
    (data_dir / "test_batch.bin").write_bytes(_cifar_records(rng, 6))
    t = tf.CifarDataSetIterator(batch=4, train=train, num_examples=8)
    assert not t.synthetic
    batches = _same_iterators(t, jf.CifarDataSetIterator(
        batch=4, train=train, num_examples=8))
    assert sum(len(x) for x, _ in batches[0]) == (8 if train else 6)


def test_svhn_mat_reads_as_jax(data_dir):
    from scipy.io import savemat

    rng = np.random.default_rng(3)
    savemat(str(data_dir / "train_32x32.mat"), {
        "X": rng.integers(0, 256, (32, 32, 3, 9)).astype(np.uint8),
        "y": rng.integers(1, 11, (9, 1)).astype(np.uint8)})
    t = tf.SvhnDataSetIterator(batch=4, num_examples=7, seed=2)
    assert not t.synthetic
    batches = _same_iterators(t, jf.SvhnDataSetIterator(
        batch=4, num_examples=7, seed=2))
    assert sum(len(x) for x, _ in batches[0]) == 7


def _image_tree(root, classes, per_class, suffix, nested=None):
    from PIL import Image

    rng = np.random.default_rng(4)
    for ci, name in enumerate(classes):
        d = root / name / nested if nested else root / name
        d.mkdir(parents=True)
        for j in range(per_class[ci]):
            h, w = 30 + 7 * j, 44 - 5 * ci
            px = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(px).save(d / f"img_{j}{suffix}")
        (d / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("cap", [None, 5])
def test_lfw_tree_reads_as_jax(data_dir, cap):
    """Directory-per-person PNGs of other sizes resized to 64x64 by PIL, a
    small num_examples spread over the people (2, 2, 1 asked; bob has
    one), one class per directory."""
    _image_tree(data_dir / "lfw", ["ann", "bob", "cyd"], [3, 1, 2], ".png")
    t = tf.LfwDataSetIterator(batch=4, num_examples=cap)
    assert not t.synthetic and t.total_outcomes() == 3
    batches = _same_iterators(t, jf.LfwDataSetIterator(batch=4,
                                                       num_examples=cap))
    assert sum(len(x) for x, _ in batches[0]) == (4 if cap else 6)


def test_tiny_imagenet_tree_reads_as_jax(data_dir):
    root = data_dir / "tiny-imagenet-200" / "train"
    _image_tree(root, ["n01", "n02"], [2, 3], ".JPEG", nested="images")
    t = tf.TinyImageNetDataSetIterator(batch=3)
    assert not t.synthetic and t.total_outcomes() == 200
    _same_iterators(t, jf.TinyImageNetDataSetIterator(batch=3))


def test_image_tree_without_pil_raises_and_never_falls_back(data_dir,
                                                            monkeypatch):
    """With image files present and no PIL the reader raises ImportError
    saying so; an empty tree needs no PIL and gives the synthetic
    sample."""
    (data_dir / "lfw" / "nobody").mkdir(parents=True)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tf.LfwDataSetIterator(num_examples=8).synthetic
    monkeypatch.delitem(sys.modules, "PIL")
    _image_tree(data_dir / "lfw", ["ann"], [2], ".png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="2 image files.*needs PIL"):
        tf.LfwDataSetIterator()


def test_iris_csv_reads_as_jax(data_dir):
    """iris.csv through the port's CSVRecordReader; a row with a field
    that does not parse is dropped in both."""
    rows = ["5.1,3.5,1.4,0.2,0", "4.9,3.0,1.4,0.2,0", "7.0,3.2,4.7,1.4,1",
            "6.4,3.2,4.5,1.5,1", "6.3,3.3,6.0,2.5,2", "5.8,2.7,bad,1.9,2",
            "7.1,3.0,5.9,2.1,2"]
    (data_dir / "iris.csv").write_text("\n".join(rows) + "\n")
    t = tf.IrisDataSetIterator(batch=4)
    batches = _same_iterators(t, jf.IrisDataSetIterator(batch=4))
    assert sum(len(x) for x, _ in batches[0]) == 6


@pytest.mark.parametrize("train", [True, False])
def test_uci_text_reads_as_jax(data_dir, train):
    rng = np.random.default_rng(5)
    np.savetxt(data_dir / "synthetic_control.data",
               rng.normal(30, 5, (12, 60)), fmt="%.4f")
    t = tf.UciSequenceDataSetIterator(batch=4, train=train, seed=8)
    assert not t.synthetic
    batches = _same_iterators(t, jf.UciSequenceDataSetIterator(
        batch=4, train=train, seed=8))
    assert batches[0][0][0].shape == (4, 60, 1)


def test_every_fetcher_is_exported():
    from deeplearning4j_tpu_torch import datasets

    for name in ("MnistDataSetIterator", "EmnistDataSetIterator",
                 "IrisDataSetIterator", "CifarDataSetIterator",
                 "SvhnDataSetIterator", "LfwDataSetIterator",
                 "TinyImageNetDataSetIterator",
                 "UciSequenceDataSetIterator"):
        assert getattr(datasets, name) is getattr(tf, name)
        assert hasattr(jf, name)
    assert os.path.basename(tf.__file__) == "fetchers.py"
