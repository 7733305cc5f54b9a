"""The record readers and the sequence iterators of the port
(deeplearning4j_tpu_torch/datasets/records.py; JointParallelDataSetIterator,
BucketSequenceIterator and prefetch_to_device in datasets/iterators.py)
against the JAX package, on the same files under tmp_path.

The JAX readers parse with the native C++ kernels when a toolchain is
present, else with numpy; the port always with numpy. So each reader is
held exactly against the JAX reader's numpy path (its native module
replaced by one that declines) and within 1 ulp-scale (1e-6 relative)
against its default path. The iterators' arrays and masks are held
exactly; a bucket-padded batch's masked loss equals the unpadded batch's
within 1e-6.
"""
import os
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iterators as jits
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu_torch.datasets import (
    BucketSequenceIterator,
    CollectionRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    DataSet,
    ExistingDataSetIterator,
    ImageRecordReader,
    JointParallelDataSetIterator,
    ListDataSetIterator,
    RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator,
    prefetch_to_device,
)
from deeplearning4j_tpu_torch.datasets import records as trec
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutput

NO_NATIVE = types.SimpleNamespace(csv_parse=lambda *a, **k: None,
                                  u8_to_f32=lambda *a, **k: None)


@pytest.fixture(params=["numpy", "default"])
def jax_path(request, monkeypatch):
    """The JAX readers' numpy path (exact) or their default path (native
    where it builds: 1e-6 relative)."""
    if request.param == "numpy":
        monkeypatch.setattr(jrec, "native", NO_NATIVE)
        return 0.0
    return 1e-6


def _same(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, want.shape, got.dtype, want.dtype)
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=str(what))
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-30,
                                   err_msg=str(what))


def _write_csv(path, rows, header=None):
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        for r in rows:
            f.write(r + "\n")


# ---------------------------------------------------------------- readers
def test_csv_reader_matches_jax(tmp_path, jax_path):
    """A header line skipped, a blank line, a bad field, a short row and
    a long one (NaN-padded and cut to the first row's width), numbers in
    several spellings."""
    rng = np.random.default_rng(1)
    rows = [",".join(f"{v:.6f}" for v in rng.normal(size=5))
            for _ in range(40)]
    rows[3] = "1e-3, -2.5E+2,+7,.5,3."
    rows[10] = ""
    rows[11] = "1,2,abc,4,5"
    rows[12] = "1,2,3"
    rows[13] = "1,2,3,4,5,6,7"
    if jax_path:
        # the native parser takes a short row's missing fields from the
        # next line; its numpy path (and the port) pads them with NaN
        rows[12] = "1,2,3,4,5"
    path = str(tmp_path / "a.csv")
    _write_csv(path, rows, header="a,b,c,d,e")
    want = jrec.CSVRecordReader(path, skip_lines=1).load()
    got = CSVRecordReader(path, skip_lines=1).load()
    _same(got, want, jax_path)
    assert got.shape == (39, 5) and np.isnan(got[10, 2])
    # the vectorized parse of a clean file equals the field-by-field one
    clean = [r for i, r in enumerate(rows) if i not in (10, 11, 12, 13)]
    path2 = str(tmp_path / "clean.csv")
    _write_csv(path2, clean)
    data = open(path2, "rb").read()
    lines = data.decode().splitlines()
    np.testing.assert_array_equal(trec.parse_csv_bytes(data),
                                  trec._parse_fields(lines, ","))
    _same(trec.parse_csv_bytes(data),
          jrec.CSVRecordReader(path2).load(), jax_path)
    semi = str(tmp_path / "semi.csv")
    _write_csv(semi, ["1;2;3", "4;5;6"])
    _same(CSVRecordReader(semi, delimiter=";").load(),
          jrec.CSVRecordReader(semi, delimiter=";").load(), jax_path)
    assert list(CollectionRecordReader([[1, 2], [3, 4]]).records())[1][
        1] == list(jrec.CollectionRecordReader([[1, 2], [3, 4]]).records())[
        1][1]


def _sequence_files(tmp_path, n=7, vocab=6, seed=2):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        t = int(rng.integers(2, 12))
        ids = rng.integers(0, vocab, t + 1)
        onehot = np.eye(vocab)[ids[:t]]
        rows = [",".join(str(int(v)) for v in oh) + f",{ids[j + 1]}"
                for j, oh in enumerate(onehot)]
        p = str(tmp_path / f"seq_{i:02d}.csv")
        _write_csv(p, rows)
        paths.append(p)
    return paths


def test_csv_sequence_reader_and_iterator_match_jax(tmp_path, jax_path):
    """One sequence per file (a glob, sorted), batches of 3 padded on the
    right with masks; classification (one-hot labels) and regression."""
    _sequence_files(tmp_path)
    pattern = str(tmp_path / "seq_*.csv")
    jseq = list(jrec.CSVSequenceRecordReader(pattern).sequences())
    tseq = list(CSVSequenceRecordReader(pattern).sequences())
    assert len(tseq) == len(jseq) == 7
    for a, b in zip(tseq, jseq):
        _same(a, b, jax_path)
    for regression in (False, True):
        kw = dict(batch=3, label_index=-1, regression=regression,
                  num_classes=None if regression else 6)
        jit_ = jrec.SequenceRecordReaderDataSetIterator(
            jrec.CSVSequenceRecordReader(pattern), **kw)
        tit = SequenceRecordReaderDataSetIterator(
            CSVSequenceRecordReader(pattern), **kw)
        for _ in range(2):  # a second pass after reset
            jb, tb = list(jit_), list(tit)
            assert [b.features.shape for b in tb] == [
                b.features.shape for b in jb]
            for a, b in zip(tb, jb):
                for f in ("features", "labels", "features_mask",
                          "labels_mask"):
                    _same(getattr(a, f), getattr(b, f), jax_path, f)


def _write_ppm(path, img):
    """uint8 [h, w, 3] as a binary (P6) PPM."""
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def _ppm_tree(tmp_path, seed=3):
    """Images in 3 class directories: PPMs of two sizes and a .npy."""
    rng = np.random.default_rng(seed)
    root = tmp_path / "images"
    for c in ("cat", "dog", "eel"):
        (root / c).mkdir(parents=True)
        for i in range(3):
            h, w = (6, 5) if i else (9, 7)
            _write_ppm(str(root / c / f"{i}.ppm"),
                       rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        np.save(str(root / c / "x.npy"),
                rng.integers(0, 256, (6, 5), dtype=np.uint8))
    return str(root)


@pytest.mark.parametrize("channels", [1, 3])
def test_image_reader_and_record_iterator_match_jax(tmp_path, jax_path,
                                                    channels):
    """Labels by parent directory in sorted order, nearest-neighbour resize
    to 6 x 5, channels cut or repeated, scaled by 1/255; then
    RecordReaderDataSetIterator(label_index=-1, num_classes=3) in batches
    of 4."""
    root = _ppm_tree(tmp_path)
    jr = jrec.ImageRecordReader(6, 5, channels, root=root)
    tr_ = ImageRecordReader(6, 5, channels, root=root)
    assert tr_.label_index == jr.label_index and tr_.num_labels() == 3
    for a, b in zip(tr_.records(), jr.records()):
        _same(a, b, jax_path)
    kw = dict(batch=4, label_index=-1, num_classes=3)
    jb = list(jrec.RecordReaderDataSetIterator(jr, **kw))
    tb = list(RecordReaderDataSetIterator(tr_, **kw))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        _same(a.features, b.features, jax_path)
        _same(a.labels, b.labels, 0.0)


def test_record_iterator_modes_match_jax(tmp_path):
    """Regression over a column range, unsupervised, classification with a
    label column in the middle, a ragged last batch; and a reset."""
    rng = np.random.default_rng(5)
    m = rng.normal(size=(11, 6)).astype(np.float32)
    m[:, 2] = rng.integers(0, 4, 11)
    for kw in (dict(label_index=2, num_classes=4),
               dict(label_index=4, label_index_to=5, regression=True),
               dict(label_index=None)):
        jit_ = jrec.RecordReaderDataSetIterator(
            jrec.CollectionRecordReader(m), batch=4, **kw)
        tit = RecordReaderDataSetIterator(CollectionRecordReader(m),
                                          batch=4, **kw)
        for _ in range(2):
            jb, tb = list(jit_), list(tit)
            assert len(tb) == len(jb) == 3
            for a, b in zip(tb, jb):
                _same(a.features, b.features, 0.0)
                _same(a.labels, b.labels, 0.0)
    with pytest.raises(ValueError, match="num_classes"):
        next(iter(RecordReaderDataSetIterator(CollectionRecordReader(m),
                                              label_index=2)))


# ---------------------------------------------------------------- iterators
def _ragged(seed, lengths, f=3, labels_mask=False, per_seq=False):
    rng = np.random.default_rng(seed)
    out = []
    for t in lengths:
        x = rng.normal(size=(2, t, f)).astype(np.float32)
        y = (rng.normal(size=(2, 4)).astype(np.float32) if per_seq
             else rng.normal(size=(2, t, 4)).astype(np.float32))
        fm = None
        lm = np.ones((2, t), np.float32) if labels_mask else None
        if labels_mask:
            lm[1, t // 2:] = 0.0
        out.append((x, y, fm, lm))
    return out


@pytest.mark.parametrize("case", ["default", "explicit", "labels_mask",
                                  "per_sequence"])
def test_bucket_iterator_matches_jax(case):
    lengths = [3, 5, 8, 9, 17, 40, 100]
    buckets = (8, 32) if case == "explicit" else None
    data = _ragged(6, lengths, labels_mask=case == "labels_mask",
                   per_seq=case == "per_sequence")
    jit_ = jits.BucketSequenceIterator(
        jits.ExistingDataSetIterator([jds.DataSet(*d) for d in data]),
        buckets=buckets, max_length=64)
    tit = BucketSequenceIterator(
        ExistingDataSetIterator([DataSet(*d) for d in data]),
        buckets=buckets, max_length=64)
    jb, tb = list(jit_), list(tit)
    assert tit.emitted_lengths() == jit_.emitted_lengths()
    assert tit.buckets == jit_.buckets
    for a, b in zip(tb, jb):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            ga, gb = getattr(a, f), getattr(b, f)
            assert (ga is None) == (gb is None), f
            if ga is not None:
                _same(ga, np.asarray(gb), 0.0, f)
    if case == "default":
        assert tit.emitted_lengths() == {4, 8, 16, 32, 64, 100}
        assert tb[-1].features.shape[1] == 100  # beyond 64: unpadded


def test_bucket_padding_keeps_the_masked_loss():
    """A GravesLSTM char-RNN's score on a padded batch (masked) equals its
    score on the unpadded batch, with and without a labels mask."""
    conf = NeuralNetConfiguration(
        seed=3, updater=updaters.Sgd(learning_rate=0.1)).list([
            GravesLSTM(n_out=8), RnnOutput(n_out=4, loss="mcxent")]
    ).set_input_type(it.recurrent(5))
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(8)
    eye5, eye4 = np.eye(5, dtype=np.float32), np.eye(4, dtype=np.float32)
    x = eye5[rng.integers(0, 5, (3, 11))]
    y = eye4[rng.integers(0, 4, (3, 11))]
    lm = np.ones((3, 11), np.float32)
    lm[2, 7:] = 0.0
    for mask in (None, lm):
        raw = DataSet(x, y, None, mask)
        padded = next(iter(BucketSequenceIterator(
            ExistingDataSetIterator([raw]), buckets=(16,))))
        assert padded.features.shape == (3, 16, 5)
        assert (padded.labels_mask is None) == (mask is None)
        a, b = net.score(raw), net.score(padded)
        assert abs(a - b) <= 1e-6 * abs(a), (a, b)


def test_joint_parallel_iterator_order_matches_jax():
    """Three streams of 4, 1 and 2 batches: round-robin skipping exhausted
    streams, then the same after a reset; next_for serves one stream."""
    def streams(mk_ds, mk_it):
        # stream s's batch i has features 10 s + i
        return [mk_it([mk_ds(np.full((2, 3), 10 * s + i, np.float32),
                             np.zeros((2, 1), np.float32))
                       for i in range(n)])
                for s, n in enumerate((4, 1, 2))]

    jj = jits.JointParallelDataSetIterator(
        *streams(jds.DataSet, jits.ExistingDataSetIterator))
    tj = JointParallelDataSetIterator(
        *streams(DataSet, ExistingDataSetIterator))
    try:
        for _ in range(2):
            want = [float(d.features[0, 0]) for d in jj]
            got = [float(d.features[0, 0]) for d in tj]
            assert got == want == [0, 10, 20, 1, 21, 2, 3]
        assert tj.attached() == 3
        tj.reset()
        assert float(tj.next_for(2).features[0, 0]) == 20
        assert float(tj.next_for(5).features[0, 0]) == 21  # 5 % 3 = 2
    finally:
        jj.shutdown()
        tj.shutdown()
        tj.shutdown()


def test_prefetch_to_device_yields_the_same_batches():
    rng = np.random.default_rng(9)
    ds = DataSet(rng.normal(size=(10, 3)).astype(np.float32),
                 rng.normal(size=(10, 2)).astype(np.float32),
                 np.ones((10, 1), np.float32), None)
    for size in (1, 2, 5):
        got = list(prefetch_to_device(ListDataSetIterator(ds, batch=3),
                                      size=size, device="cpu"))
        assert len(got) == 4
        for i, b in enumerate(got):
            assert isinstance(b.features, torch.Tensor)
            np.testing.assert_array_equal(b.features.numpy(),
                                          ds.features[3 * i:3 * i + 3])
            np.testing.assert_array_equal(b.features_mask.numpy(),
                                          ds.features_mask[3 * i:3 * i + 3])
            assert b.labels_mask is None


def test_ppm_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (4, 3, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "a.ppm")
    _write_ppm(path, img)
    np.testing.assert_array_equal(trec.read_ppm(path), img)
    np.testing.assert_array_equal(jrec._read_ppm(path), img)
    with open(path, "wb") as f:
        f.write(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="not a P6"):
        trec.read_ppm(path)
    assert os.path.exists(path)
