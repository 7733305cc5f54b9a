"""The port's HDF5 module (deeplearning4j_tpu_torch/modelimport/hdf5.py)
against h5py, in both directions.

Files h5py writes (libhdf5's default format, as Keras writes them: nested
groups, groups large enough for a multi-level B-tree, attributes added
after the datasets so that object headers continue elsewhere, compact,
scalar, empty and never-written datasets, fixed- and variable-length
string attributes, a string above 64 KiB) read back with the same names,
dtypes, shapes and values, bit for bit. Files the port writes read back in
h5py the same way (numbers in native byte order). Formats outside the
subset raise NotImplementedError.
"""
import json

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu_torch.modelimport import hdf5


def _h5py_file(path, rng):
    big = json.dumps({"layers": ["x" * 100] * 800})  # about 82 KB
    with h5py.File(path, "w") as f:
        mw = f.require_group("model_weights")
        for i in range(70):  # more entries than one B-tree leaf holds
            g = mw.require_group(f"layer_{i:03d}")
            g.create_dataset("kernel:0", data=rng.standard_normal(
                (2, 3)).astype(np.float32))
            g.create_dataset("bias:0", data=np.arange(3, dtype=np.int64))
            g.attrs["weight_names"] = [f"layer_{i:03d}/kernel:0".encode(),
                                       f"layer_{i:03d}/bias:0".encode()]
        deep = f.require_group("a/b/c")
        deep.create_dataset("f64", data=rng.standard_normal((4, 1, 2)))
        deep.create_dataset("i16", data=np.arange(-3, 3, dtype=np.int16))
        deep.create_dataset("u8", data=np.arange(5, dtype=np.uint8))
        deep.create_dataset("f16", data=np.ones(3, np.float16))
        deep.create_dataset("big_endian", data=np.arange(4, dtype=">f4"))
        f.create_dataset("scalar", data=np.float32(3.5))
        f.create_dataset("empty", shape=(0,), dtype=np.float32)
        f.create_dataset("unwritten", shape=(3,), dtype=np.float32)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F64LE,
                        h5py.h5s.create_simple((4,)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4.0))
        # attributes after the datasets: the headers grow by continuation
        f.attrs["model_config"] = big
        f.attrs["keras_version"] = b"2.1.2"
        f.attrs["fixed"] = np.array([b"ab", b"cde"])
        f.attrs["numbers"] = np.arange(3.0)
        f.attrs["count"] = np.int32(7)
        for i in range(40):
            deep.attrs[f"attr_{i}"] = "v" * 200


def _same(a, b, where):
    if isinstance(a, (str, bytes)) or np.ndim(a) == 0:
        assert type(a) is type(b), where
        assert a == b, where
        return
    a, b = np.asarray(a), np.asarray(b)
    # the port reads numbers in native byte order (h5py keeps the file's)
    assert a.dtype.newbyteorder("=") == b.dtype and a.shape == b.shape, where
    assert np.array_equal(a, b), where


def _compare(path, h5py_side, port_side):
    with h5py_side(path) as a, port_side(path) as b:
        names, seen = [], []
        a.visititems(lambda n, o: names.append(n))
        b.visititems(lambda n, o: seen.append(n))
        assert names == seen
        for n in [""] + names:
            x, y = (a[n], b[n]) if n else (a, b)
            assert sorted(x.attrs) == sorted(y.attrs), n
            for k in x.attrs:
                _same(x.attrs[k], y.attrs[k], f"{n}@{k}")
            if isinstance(x, h5py.Dataset):
                assert isinstance(y, hdf5.Dataset), n
                _same(x[()], y[()], n)
            else:
                assert isinstance(y, hdf5.Group), n
        return len(names)


def test_reads_what_h5py_writes(tmp_path):
    path = tmp_path / "h5py.h5"
    _h5py_file(path, np.random.default_rng(0))
    n = _compare(path, lambda p: h5py.File(p, "r"), hdf5.File)
    assert n > 70 * 3
    with hdf5.File(path) as f:
        assert "model_weights/layer_042/kernel:0" in f
        assert "model_weights/nope" not in f
        assert f["model_weights"]["layer_005"].attrs["weight_names"].tolist() \
            == ["layer_005/kernel:0", "layer_005/bias:0"]
        assert np.asarray(f["unwritten"]).tolist() == [0.0, 0.0, 0.0]
        assert json.loads(f.attrs["model_config"])["layers"][0] == "x" * 100


def test_h5py_reads_what_the_port_writes(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "port.h5"
    arrays = {}
    with hdf5.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps({"big": "y" * 70000})
        f.attrs["training_config"] = json.dumps({"loss": "mse"})
        f.attrs["numbers"] = np.arange(4, dtype=np.int64)
        f.attrs["names"] = [b"a", b"bcd"]
        mw = f.require_group("model_weights")
        for i in range(200):  # one symbol table node holds them all
            g = mw.require_group(f"conv_{i}")
            arr = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
            arrays[f"model_weights/conv_{i}/kernel:0"] = arr
            g.create_dataset("kernel:0", data=arr)
            g.attrs["weight_names"] = [f"conv_{i}/kernel:0".encode()]
        mw.require_group("empty_group")
        f.create_dataset("nested/deeper/i32", data=np.arange(5, dtype=np.int32))
        f.create_dataset("scalar", data=np.float64(2.5))
        f.create_dataset("empty", data=np.zeros((0, 3), np.float32))
    n = _compare(path, lambda p: h5py.File(p, "r"), hdf5.File)
    assert n == 1 + 200 * 2 + 1 + 2 + 1 + 2
    with h5py.File(path, "r") as f:
        for k, arr in arrays.items():
            np.testing.assert_array_equal(f[k][()], arr)
        assert f.attrs["model_config"] == json.dumps({"big": "y" * 70000})
        assert list(f["model_weights/conv_7"].attrs["weight_names"]) == [
            "conv_7/kernel:0"]
        assert list(f["model_weights/empty_group"]) == []


def test_formats_outside_the_subset_raise(tmp_path):
    chunked = tmp_path / "chunked.h5"
    with h5py.File(chunked, "w") as f:
        f.create_dataset("x", data=np.zeros((4, 4)), chunks=(2, 2))
    with hdf5.File(chunked) as f:
        with pytest.raises(NotImplementedError, match="chunked"):
            f["x"][()]
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("x", data=np.zeros(2))
    with pytest.raises(NotImplementedError, match="superblock version"):
        hdf5.File(latest)
    not_hdf5 = tmp_path / "x.h5"
    not_hdf5.write_bytes(b"not an hdf5 file at all" * 40)
    with pytest.raises(ValueError, match="no HDF5 signature"):
        hdf5.File(not_hdf5)
    with pytest.raises(ValueError, match="mode"):
        hdf5.File(latest, "a")
