"""The port's Keras importer on the reference's own committed fixtures
(tests/fixtures/keras_ref/, as tests/test_keras_ref_fixtures.py uses
them), against the JAX package's importer.

Every config JSON (Keras 1 and 2, Sequential and functional) builds in the
port with the JAX network's parameter count and the same parameter names
and shapes in the interchange layout. The tfscope files (an .h5 with
TF-scoped weight datasets and no weight_names, and the model.json +
model.weight pair) import with the same weights, bit for bit, and give
outputs within 1e-5 of the JAX network's largest magnitude.
"""
import os

import numpy as np
import pytest

from deeplearning4j_tpu.modelimport import (
    import_keras_model_configuration as jax_config,
)
from deeplearning4j_tpu.modelimport import (
    import_keras_sequential_model_and_weights as jax_import_seq,
)
from deeplearning4j_tpu_torch.modelimport import (
    import_keras_model_configuration,
    import_keras_sequential_model_and_weights,
)
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from test_keras_ref_fixtures import _CONFIGS, FIX


def _shapes(table):
    return {k: tuple(np.shape(v)) for k, v in table.items()}


@pytest.mark.parametrize(
    "path", _CONFIGS, ids=[os.path.basename(p) for p in _CONFIGS])
def test_reference_config_builds_like_jax(path):
    tnet = import_keras_model_configuration(path, device="cpu")
    jnet = jax_config(path)
    assert type(tnet).__name__ == type(jnet).__name__
    assert isinstance(tnet, (MultiLayerNetwork, ComputationGraph))
    assert tnet.num_params() == jnet.num_params() > 0
    assert _shapes(tnet.get_param_table()) == \
        _shapes(jnet.get_param_table())
    if isinstance(tnet, MultiLayerNetwork):
        assert [type(l).__name__ for l in tnet.layers] == \
            [type(l).__name__ for l in jnet.layers]
        assert sorted(tnet.conf.input_preprocessors) == \
            sorted(jnet.conf.input_preprocessors)
    else:
        assert tnet.topo == jnet.topo


def _same_weights_and_outputs(tnet, jnet, x):
    tt, jt = tnet.get_param_table(), jnet.get_param_table()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x).numpy()
    assert got.shape == want.shape == (x.shape[0], 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", ["model.h5",
                                  "model.h5.with.tensorflow.scope"])
def test_tfscope_h5_matches_jax(name):
    path = os.path.join(FIX, "tfscope", name)
    tnet = import_keras_sequential_model_and_weights(path, device="cpu")
    assert [type(l).__name__ for l in tnet.layers] == ["Dense", "Output"]
    x = np.random.default_rng(3).standard_normal((4, 70)).astype(np.float32)
    _same_weights_and_outputs(tnet, jax_import_seq(path), x)


@pytest.mark.parametrize("suffix", ["", ".with.tensorflow.scope"])
def test_tfscope_json_plus_weights_matches_jax(suffix):
    args = (os.path.join(FIX, "tfscope", "model.json" + suffix),
            os.path.join(FIX, "tfscope", "model.weight" + suffix))
    tnet = import_keras_sequential_model_and_weights(*args, device="cpu")
    x = np.random.default_rng(4).standard_normal((4, 70)).astype(np.float32)
    _same_weights_and_outputs(tnet, jax_import_seq(*args), x)
