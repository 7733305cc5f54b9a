"""The port's data normalizers against the JAX package's: fit, transform
and revert for each of the three on the same seeded data (features and,
where the normalizer takes them, labels), fitted over an iterator of
several batches; `normalizer.bin` (DL4J's NormalizerSerializer stream) and
`normalizer.json` (the checkpoint zip's) written by either package and read
by the other; and an iterator's pre-processor hook.

Tolerances: statistics 1e-6 relative (float64 sums in another order, then
float32), transformed and reverted values 1e-6 absolute (the same float32
operations).
"""
import io
import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import normalizers as jn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.modelimport import dl4j as jd
from deeplearning4j_tpu.models import serialization as jser
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ImagePreProcessingScaler,
    ListDataSetIterator,
    Normalizer,
    NormalizerMinMaxScaler,
    NormalizerStandardize,
)
from deeplearning4j_tpu_torch.modelimport import dl4j as td
from deeplearning4j_tpu_torch.models import MultiLayerNetwork, write_model
from deeplearning4j_tpu_torch.models import serialization as tser
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import Output

KINDS = {
    "standardize": (lambda: NormalizerStandardize(fit_labels=True),
                    lambda: jn.NormalizerStandardize(fit_labels=True)),
    "minmax": (lambda: NormalizerMinMaxScaler(-1.0, 2.0, fit_labels=True),
               lambda: jn.NormalizerMinMaxScaler(-1.0, 2.0,
                                                 fit_labels=True)),
    "image": (lambda: ImagePreProcessingScaler(-0.5, 0.5, 255.0),
              lambda: jn.ImagePreProcessingScaler(-0.5, 0.5, 255.0)),
}
STATS = ("mean", "std", "label_mean", "label_std", "data_min", "data_max",
         "label_min", "label_max")


def _batches(rng, kind, n=3):
    """n batches of [8, 5, 4] features (pixels for the image scaler) and
    [8, 5, 3] labels, with offsets and scales per feature."""
    out = []
    for _ in range(n):
        if kind == "image":
            x = rng.integers(0, 256, (8, 5, 4)).astype(np.float32)
        else:
            x = (rng.normal(0, 1, (8, 5, 4)) * [1.0, 10.0, 0.1, 3.0]
                 + [5.0, -2.0, 0.0, 100.0]).astype(np.float32)
        y = rng.normal(2.0, 4.0, (8, 5, 3)).astype(np.float32)
        out.append((x, y))
    return out


def _check_stats(t, j):
    for name in STATS:
        want = getattr(j, name, None)
        got = getattr(t, name, None)
        assert (want is None) == (got is None), name
        if want is not None:
            assert got.dtype == torch.float32, name
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fit_transform_revert_match_jax(rng, kind):
    batches = _batches(rng, kind)
    t, j = (f() for f in KINDS[kind])
    t.fit([DataSet(x, y) for x, y in batches])
    j.fit([JDataSet(x, y) for x, y in batches])
    _check_stats(t, j)
    x, y = batches[0]
    got, want = t.transform(DataSet(x, y)), j.transform(JDataSet(x, y))
    for g, w in ((got.features, want.features), (got.labels, want.labels)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
    assert got.features.dtype == torch.float32
    back = t.revert(got)
    np.testing.assert_allclose(back.features.numpy(),
                               np.asarray(j.revert(want).features),
                               atol=1e-5)
    np.testing.assert_allclose(back.features.numpy(), x,
                               atol=1e-4 * np.abs(x).max())


def test_transform_keeps_tensors_on_their_device_and_masks(rng):
    x, y = _batches(rng, "standardize", 1)[0]
    t = NormalizerStandardize().fit(DataSet(torch.from_numpy(x), y))
    mask = np.ones((8, 5), np.float32)
    out = t.transform(DataSet(torch.from_numpy(x), y, mask, mask))
    assert isinstance(out.features, torch.Tensor)
    assert out.features.device == t.mean.device
    assert out.features_mask is mask and out.labels is y


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_normalizer_bin_both_ways(rng, kind):
    """The port writes the JAX package's bytes; each reads the other's
    stream into equal statistics."""
    batches = _batches(rng, kind)
    t, j = (f() for f in KINDS[kind])
    t.fit([DataSet(x, y) for x, y in batches])
    j.fit([JDataSet(x, y) for x, y in batches])
    # identical statistics on both sides, so the bytes can match
    for name in STATS:
        if getattr(j, name, None) is not None:
            setattr(t, name, torch.from_numpy(np.asarray(getattr(j, name))))
    tb, jb = io.BytesIO(), io.BytesIO()
    td.write_normalizer(tb, t)
    jd.write_normalizer(jb, j)
    assert tb.getvalue() == jb.getvalue()
    tb.seek(0)
    jb.seek(0)
    from_jax, from_port = td.read_normalizer(jb), jd.read_normalizer(tb)
    assert type(from_jax) is type(t) and type(from_port) is type(j)
    _check_stats(from_jax, j)
    _check_stats(t, from_port)
    for attr in ("min_range", "max_range", "max_pixel", "fit_labels"):
        assert getattr(from_jax, attr, None) == getattr(j, attr, None)


def test_unknown_normalizer_strategy_refused():
    buf = io.BytesIO()
    td._write_utf(buf, "MULTI_STANDARDIZE")
    buf.seek(0)
    with pytest.raises(ValueError, match="MULTI_STANDARDIZE"):
        td.read_normalizer(buf)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_normalizer_json_both_ways(rng, kind):
    batches = _batches(rng, kind)
    t, j = (f() for f in KINDS[kind])
    t.fit([DataSet(x, y) for x, y in batches])
    j.fit([JDataSet(x, y) for x, y in batches])
    _check_stats(Normalizer.from_json(json.loads(json.dumps(j.to_json()))),
                 j)
    back = jn.Normalizer.from_json(json.loads(json.dumps(t.to_json())))
    _check_stats(t, back)
    assert sorted(t.to_json()) == sorted(j.to_json())


def test_checkpoint_normalizer_json_crosses_packages(tmp_path, rng):
    """write_model(..., normalizer=) in the port, restore_normalizer in
    JAX; and the reverse through the JAX package's writer."""
    x, y = _batches(rng, "standardize", 1)[0]
    norm = NormalizerStandardize().fit(DataSet(x, y))
    net = MultiLayerNetwork(NeuralNetConfiguration(seed=1).list(
        [Output(n_out=3, loss="mse", activation="identity")])
        .set_input_type(it.feed_forward(4))).init("cpu")
    path = str(tmp_path / "m.zip")
    write_model(net, path, normalizer=norm)
    got = jser.restore_normalizer(path)
    np.testing.assert_array_equal(got.mean, norm.mean.numpy())
    jnet = jser.restore_model(path)
    jpath = str(tmp_path / "j.zip")
    jser.write_model(jnet, jpath, normalizer=got)
    back = tser.restore_normalizer(jpath)
    assert isinstance(back, NormalizerStandardize)
    np.testing.assert_array_equal(back.std.numpy(), norm.std.numpy())
    assert tser.restore_normalizer(str(tmp_path / "m.zip")) is not None


def test_iterator_pre_processor_matches_jax(rng):
    """set_pre_processor: every batch the iterator yields is transformed,
    as the JAX package's iterator does it."""
    x, y = _batches(rng, "minmax", 1)[0]
    t = NormalizerMinMaxScaler().fit(DataSet(x, y))
    j = jn.NormalizerMinMaxScaler().fit(JDataSet(x, y))
    tit = ListDataSetIterator(DataSet(x, y), batch=3).set_pre_processor(t)
    jit_ = JListIterator(JDataSet(x, y), batch=3).set_pre_processor(j)
    got, want = list(tit), list(jit_)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.features.numpy(),
                                   np.asarray(w.features), atol=1e-6)
    tit.set_pre_processor(lambda ds: DataSet(ds.features * 0, ds.labels))
    assert all(float(np.abs(d.features).max()) == 0 for d in tit)
