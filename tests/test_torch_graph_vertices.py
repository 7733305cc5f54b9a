"""The graph vertices the DL4J importer creates (Subset, Stack, Unstack, L2,
L2Normalize, Scale, Shift, PoolHelper) and the LRN layer, against the JAX
package's: forward and the gradient of a seeded weighted sum of the output
with respect to every input, on the same seeded inputs, and the JSON round
trip across both packages; then each in a small graph restored from a DL4J
zip by both importers.

Tolerances: 1e-6 relative to each output's largest magnitude for the
forward and the gradients (the same float32 operations, sums in another
order).
"""
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import dl4j as jd
from deeplearning4j_tpu.nn import graph_vertices as jgv
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn.layers import LRN as JLRN
from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
from deeplearning4j_tpu_torch.modelimport import dl4j as td
from deeplearning4j_tpu_torch.nn import graph_vertices as tgv
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers import LRN
from deeplearning4j_tpu_torch.nn.layers.base import Layer

# name -> (kwargs, input shapes, input types (port), input types (JAX))
VERTICES = {
    "SubsetVertex": ({"from_idx": 1, "to_idx": 3}, [(4, 6)],
                     [it.feed_forward(6)], [jit.feed_forward(6)]),
    "StackVertex": ({}, [(2, 5), (3, 5)], [it.feed_forward(5)] * 2,
                    [jit.feed_forward(5)] * 2),
    "UnstackVertex": ({"from_idx": 1, "stack_size": 3}, [(6, 4)],
                      [it.feed_forward(4)], [jit.feed_forward(4)]),
    "L2Vertex": ({}, [(4, 3, 2), (4, 3, 2)], [it.recurrent(2, 3)] * 2,
                 [jit.recurrent(2, 3)] * 2),
    "L2NormalizeVertex": ({}, [(3, 4, 4, 2)], [it.convolutional(4, 4, 2)],
                          [jit.convolutional(4, 4, 2)]),
    "ScaleVertex": ({"scale_factor": -2.5}, [(3, 7)], [it.feed_forward(7)],
                    [jit.feed_forward(7)]),
    "ShiftVertex": ({"shift_factor": 0.75}, [(3, 7)], [it.feed_forward(7)],
                    [jit.feed_forward(7)]),
    "PoolHelperVertex": ({}, [(2, 5, 5, 3)], [it.convolutional(5, 5, 3)],
                         [jit.convolutional(5, 5, 3)]),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _compare(t_fn, j_fn, xs, rng):
    """Forward of both, and the gradients of sum(out * w) for a seeded w."""
    jout = j_fn([jnp.asarray(x) for x in xs])
    w = rng.normal(0, 1, np.shape(jout)).astype(np.float32)
    tx = [torch.tensor(x, requires_grad=True) for x in xs]
    tout = t_fn(tx)
    assert _rel(tout.detach().numpy(), jout) <= 1e-6
    (tout * torch.from_numpy(w)).sum().backward()
    jgrads = jax.grad(lambda *a: jnp.sum(j_fn(list(a)) * w),
                      argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    for t, j in zip(tx, jgrads):
        assert _rel(t.grad.numpy(), j) <= 1e-6


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertex_matches_jax(rng, name):
    kwargs, shapes, ttypes, jtypes = VERTICES[name]
    tv, jv = getattr(tgv, name)(**kwargs), getattr(jgv, name)(**kwargs)
    xs = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    _compare(lambda a: tv.apply({}, a, state={}, train=True)[0],
             lambda a: jv.apply({}, a, state={}, train=True, rng=None)[0],
             xs, rng)
    assert tv.output_type(ttypes).to_json() == \
        jv.output_type(jtypes).to_json()
    # JSON: the port's reads in JAX and back
    d = tv.to_json()
    assert d == jv.to_json()
    assert jgv.GraphVertex.from_json(json.loads(json.dumps(d))).to_json() \
        == d
    assert tgv.GraphVertex.from_json(json.loads(json.dumps(d))) == tv


@pytest.mark.parametrize("cfg", [{}, {"n": 3, "k": 1.0, "alpha": 0.5,
                                      "beta": 0.6}], ids=["default", "wide"])
def test_lrn_matches_jax(rng, cfg):
    t, j = LRN(**cfg), JLRN(**cfg)
    x = rng.normal(0, 2, (2, 3, 3, 7)).astype(np.float32)
    _compare(lambda a: t.apply({}, a[0], state={}, train=False)[0],
             lambda a: j.apply({}, a[0], state={}, train=False, rng=None)[0],
             [x], rng)
    d = t.to_json()
    assert d == j.to_json()
    assert JLayer.from_json(d).to_json() == d
    assert Layer.from_json(j.to_json()) == t
    assert not t.has_params()


def _graph_zip(path, rng, vertex, body, n_in=4):
    """in -> dense a (4 -> 6) -> `vertex` -> output, as a DL4J zip."""
    def layer(kind, n_i, n_o, **extra):
        return {"LayerVertex": {"layerConf": {"layer": {kind: dict(
            nin=n_i, nout=n_o, updater="SGD", learningRate=0.1, **extra)}},
            "preProcessor": None}}

    conf = {"networkInputs": ["in"], "networkOutputs": ["out"],
            "vertices": {"a": layer("dense", n_in, 6,
                                    activationFunction="tanh"),
                         "v": {vertex: body},
                         "out": layer("output", 3, 2,
                                      activationFunction="softmax",
                                      lossFunction="MCXENT")},
            "vertexInputs": {"a": ["in"], "v": ["a"], "out": ["v"]}}
    flat = rng.normal(0, 0.5, n_in * 6 + 6 + 3 * 2 + 2).astype(np.float32)
    buf = io.BytesIO()
    td.write_nd4j_array(buf, flat[None, :], order="f")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", buf.getvalue())


@pytest.mark.parametrize("vertex,body", [
    ("SubsetVertex", {"from": 2, "to": 4}),
    ("ScaleVertex", {"scaleFactor": 3.0}),
], ids=["subset", "scale"])
def test_imported_graph_with_vertex_matches_jax(tmp_path, rng, vertex, body):
    """A DL4J graph whose middle vertex is one of these: both importers
    build it from the reference's JSON fields and compute the same output
    (a Scale keeps its 6 features, so its output layer reads them)."""
    n_out_mid = 3 if vertex == "SubsetVertex" else 6
    path = tmp_path / "g.zip"
    _graph_zip(path, rng, vertex, body)
    if n_out_mid == 6:
        with zipfile.ZipFile(path) as zf:
            conf = json.loads(zf.read("configuration.json"))
        conf["vertices"]["out"]["LayerVertex"]["layerConf"]["layer"][
            "output"]["nin"] = 6
        flat = rng.normal(0, 0.5, 4 * 6 + 6 + 6 * 2 + 2).astype(np.float32)
        buf = io.BytesIO()
        td.write_nd4j_array(buf, flat[None, :], order="f")
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("configuration.json", json.dumps(conf))
            zf.writestr("coefficients.bin", buf.getvalue())
    tnet = td.restore_computation_graph(str(path), device="cpu")
    jnet = jd.restore_computation_graph(str(path))
    x = rng.normal(0, 1, (5, 4)).astype(np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    assert type(tnet.conf.vertices["v"]).__name__ == vertex
