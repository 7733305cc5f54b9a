"""Yolo2Output and its decode (nn/layers/objdetect.py) in the port, against
the JAX package.

Activations and labels are made with numpy from a seed: labels with empty
cells, one or several objects per image, and anchors whose IoUs tie (two
anchors of one size and the same activations; a prediction that misses the
box, where every IoU is 0), so the responsible anchor must be the first of
the tied ones, as jnp.argmax takes it. Tolerances: the score and the
gradient with respect to the activations 1e-5 of their largest magnitude
(float32 sums in another order); the decoded lists equal in length, order,
image, class and anchor cell, their floats within 1e-6 absolute; NMS keeps
the same boxes in the same order.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import inputs as jit
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import objdetect as jod
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import objdetect as tod
from deeplearning4j_tpu_torch.nn.layers.base import Layer

BOXES = [[1.0, 1.5], [1.0, 1.5], [2.5, 1.2]]  # anchors 0 and 1 tie
C = 3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _layers(**kw):
    j = jl.Yolo2Output(boxes=BOXES, num_classes=C, **kw)
    t = Layer.from_json(json.loads(json.dumps(j.to_json())))
    assert json.dumps(t.to_json()) == json.dumps(j.to_json())
    return j, t


def yolo_labels(rng, b, H, W, n_classes, objects=(1, 4), empty=()):
    """[b, H, W, 4 + C] labels: per image a seeded number of boxes in
    `objects`, each written into the cell of its center; images in `empty`
    hold none."""
    y = np.zeros((b, H, W, 4 + n_classes), np.float32)
    for i in range(b):
        if i in empty:
            continue
        for _ in range(rng.integers(objects[0], objects[1] + 1)):
            cx, cy = rng.uniform(0.05, 0.95, 2)
            w, h = rng.uniform(0.05, 0.5, 2)
            r, c = min(int(cy * H), H - 1), min(int(cx * W), W - 1)
            y[i, r, c, :4] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            y[i, r, c, 4:] = 0.0
            y[i, r, c, 4 + rng.integers(n_classes)] = 1.0
    return y


def _activations(rng, b, H, W, tie=True):
    x = rng.standard_normal((b, H, W, len(BOXES) * (5 + C))).astype(
        np.float32)
    x5 = x.reshape(b, H, W, len(BOXES), 5 + C)
    if tie:  # anchors 0 and 1: the same size and activations -> tied IoUs
        x5[..., 1, :] = x5[..., 0, :]
    return x5.reshape(x.shape)


CASES = {
    "several-objects": dict(b=4, H=5, W=6, objects=(1, 4), empty=()),
    "empty-images": dict(b=3, H=4, W=4, objects=(1, 2), empty=(0, 2)),
    "all-empty": dict(b=2, H=3, W=3, objects=(1, 1), empty=(0, 1)),
}


@pytest.mark.parametrize("lambdas", [{}, dict(lambda_coord=2.0,
                                              lambda_no_obj=0.25)],
                         ids=["default", "lambdas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_yolo_loss_and_gradient_match_jax(case, lambdas):
    spec = CASES[case]
    rng = np.random.default_rng(len(case))
    jlayer, tlayer = _layers(**lambdas)
    x = _activations(rng, spec["b"], spec["H"], spec["W"])
    y = yolo_labels(rng, spec["b"], spec["H"], spec["W"], C,
                    spec["objects"], spec["empty"])

    def jloss(xx):
        return jlayer.compute_loss({}, xx, jnp.asarray(y), state={})

    jscore, jper, _ = jloss(jnp.asarray(x))
    jg = jax.grad(lambda xx: jloss(xx)[0])(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tscore, tper, state = tlayer.compute_loss({}, tx, torch.from_numpy(y),
                                              state={})
    tscore.backward()
    assert state == {}
    assert abs(tscore.item() - float(jscore)) <= 1e-5 * abs(float(jscore))
    assert _rel(tper.detach().numpy(), jper) <= 1e-5
    assert _rel(tx.grad.numpy(), jg) <= 1e-5
    assert np.isfinite(tx.grad.numpy()).all()


def test_tied_ious_take_the_first_anchor():
    """Every IoU ties at 0 (the box lies far from each prediction) or
    between anchors 0 and 1: the port's responsible anchor is the first,
    as jnp.argmax's."""
    v = torch.tensor([[0.0, 0.0, 0.0], [0.2, 0.7, 0.7], [0.5, 0.1, 0.5],
                      [0.3, 0.3, 0.9]])
    got = tod._first_argmax(v)
    assert got.tolist() == np.asarray(jnp.argmax(jnp.asarray(v.numpy()),
                                                 axis=-1)).tolist()
    assert got.tolist() == [0, 1, 0, 2]


def test_nan_iou_takes_the_nan_anchor_as_jax():
    """A NaN IoU (activations of a diverged run) counts as the largest, as
    jnp.argmax takes it, so the loss of a NaN activation is a NaN score
    (which a DivergenceSentry can roll back), not an error; the other
    images' scores are JAX's within 1e-5."""
    nan = float("nan")
    v = torch.tensor([[0.2, nan, 0.9], [0.9, 0.1, nan], [nan, nan, 0.3],
                      [0.1, 0.4, 0.2]])
    got = tod._first_argmax(v)
    assert got.tolist() == np.asarray(jnp.argmax(jnp.asarray(v.numpy()),
                                                 axis=-1)).tolist()
    assert got.tolist() == [1, 2, 0, 1]
    rng = np.random.default_rng(11)
    jlayer, tlayer = _layers()
    x = _activations(rng, 3, 4, 4)
    y = yolo_labels(rng, 3, 4, 4, C, objects=(2, 3))
    r, c = np.argwhere(y[1, ..., 4:].sum(-1) > 0)[0]
    x[1, r, c, 2] = nan  # an anchor's tw in a cell that holds an object
    jscore, jper, _ = jlayer.compute_loss({}, jnp.asarray(x), jnp.asarray(y),
                                          state={})
    tscore, tper, _ = tlayer.compute_loss({}, torch.from_numpy(x),
                                          torch.from_numpy(y), state={})
    assert np.isnan(float(jscore)) and np.isnan(tscore.item())
    jper, tper = np.asarray(jper), tper.numpy()
    assert np.isnan(jper[1]) and np.isnan(tper[1])
    keep = [0, 2]
    assert _rel(tper[keep], jper[keep]) <= 1e-5


def _same_objects(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert (a.example, a.predicted_class) == (b.example,
                                                  b.predicted_class)
        for f in ("center_x", "center_y", "width", "height", "confidence"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-6, f
        np.testing.assert_allclose(a.class_probabilities,
                                   b.class_probabilities, atol=1e-6)


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.8])
def test_decode_and_nms_match_jax(threshold):
    """get_predicted_objects (the threshold taken on the tensor, only the
    kept anchors copied out), decode_predictions and per-class NMS at
    three IoU thresholds: the same lists in the same order."""
    rng = np.random.default_rng(int(threshold * 10))
    jlayer, tlayer = _layers()
    x = _activations(rng, 3, 5, 4, tie=False)
    tobjs = tod.get_predicted_objects(tlayer, torch.from_numpy(x), threshold)
    jobjs = jod.get_predicted_objects(jlayer, x, threshold)
    assert len(jobjs) > 3
    _same_objects(tobjs, jobjs)
    # the port also takes a numpy array, as the JAX package does
    _same_objects(tod.get_predicted_objects(tlayer, x, threshold), jobjs)
    td = tlayer.decode_predictions(torch.from_numpy(x), threshold)
    jd = jlayer.decode_predictions(x, threshold)
    assert [len(r) for r in td] == [len(r) for r in jd]
    for tr, jr in zip(td, jd):
        for a, b in zip(tr, jr):
            assert a[5] == b[5]
            np.testing.assert_allclose(a[:5], b[:5], atol=1e-6)
    for iou in (0.1, 0.3, 0.6):
        _same_objects(tod.non_max_suppression(tobjs, iou),
                      jod.non_max_suppression(jobjs, iou))
    assert len(tod.non_max_suppression(tobjs, 0.1)) < len(tobjs)


def test_nms_keeps_the_other_class_and_image():
    """Overlapping boxes of another class or image survive; the less
    confident same-class overlap goes."""
    D = tod.DetectedObject
    objs = [D(0, 1.0, 1.0, 1.0, 1.0, 0, 0.9), D(0, 1.1, 1.0, 1.0, 1.0, 0, 0.8),
            D(0, 1.1, 1.0, 1.0, 1.0, 1, 0.7), D(1, 1.1, 1.0, 1.0, 1.0, 0, 0.6)]
    kept = tod.non_max_suppression(objs, 0.5)
    assert [o.confidence for o in kept] == [0.9, 0.7, 0.6]
    J = jod.DetectedObject
    jkept = jod.non_max_suppression(
        [J(**o.__dict__) for o in objs], 0.5)
    assert [o.confidence for o in jkept] == [0.9, 0.7, 0.6]


def _yolo_net(updater):
    return JNNC(seed=6, updater=updater, l2=1e-4).list([
        jl.Conv2D(kernel_size=(3, 3), n_out=6, convolution_mode="same",
                  has_bias=False),
        jl.BatchNorm(activation="leakyrelu"),
        jl.Subsampling2D(kernel_size=(2, 2), stride=(2, 2)),
        jl.Conv2D(kernel_size=(1, 1), n_out=len(BOXES) * (5 + C),
                  convolution_mode="same"),
        jl.Yolo2Output(boxes=BOXES, num_classes=C),
    ]).set_input_type(jit.convolutional(8, 10, 3))


def test_yolo_network_fits_as_jax():
    """3 Adam steps of a conv + leaky BatchNorm + Yolo2Output network in
    both packages: per-step scores 1e-5 relative, params and BatchNorm
    statistics 1e-5 absolute."""
    jnet = JMLN(_yolo_net(jupd.Adam(learning_rate=1e-2))).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")
    interop.params_from_jax(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state))
    rng = np.random.default_rng(4)
    for step in range(3):
        x = rng.standard_normal((4, 8, 10, 3)).astype(np.float32)
        y = yolo_labels(rng, 4, 4, 5, C, empty=(2,) if step == 1 else ())
        jnet.fit(x, y)
        tnet.fit(x, y)
        js = float(jnet.score_)
        assert abs(tnet.score_ - js) <= 1e-5 * abs(js), step
        jt = jnet.get_param_table()
        for k, v in tnet.get_param_table().items():
            assert np.abs(v - np.asarray(jt[k])).max() <= 1e-5, (step, k)
        for k, s in jnet.state.items():
            for n, v in s.items():
                assert np.abs(tnet.state[k][n].numpy()
                              - np.asarray(v)).max() <= 1e-5, (step, k, n)
    out = tnet.output(x).numpy()
    assert out.shape == (4, 4, 5, len(BOXES) * (5 + C))
    assert _rel(out, np.asarray(jnet.output(x))) <= 1e-5


def test_jax_checkpoint_of_a_yolo_network_restores_and_trains(tmp_path):
    """A JAX-written checkpoint zip of the Yolo2Output network (its
    refusal lifted) restores in the port with its Adam slots and
    BatchNorm state, and trains 2 steps as the JAX copy does."""
    from deeplearning4j_tpu.models import serialization as jser
    from deeplearning4j_tpu_torch.models import restore_model

    jnet = JMLN(_yolo_net(jupd.Adam(learning_rate=1e-2))).init()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 8, 10, 3)).astype(np.float32)
    jnet.fit(x, yolo_labels(rng, 4, 4, 5, C))
    path = str(tmp_path / "yolo.zip")
    jser.write_model(jnet, path)
    tnet = restore_model(path, device="cpu")
    jnet = jser.restore_model(path)
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert type(tnet.layers[-1]).__name__ == "Yolo2Output"
    for step in range(2):
        x = rng.standard_normal((4, 8, 10, 3)).astype(np.float32)
        y = yolo_labels(rng, 4, 4, 5, C)
        jnet.fit(x, y)
        tnet.fit(x, y)
        js = float(jnet.score_)
        assert abs(tnet.score_ - js) <= 1e-5 * abs(js), step
        jt = jnet.get_param_table()
        for k, v in tnet.get_param_table().items():
            assert np.abs(v - np.asarray(jt[k])).max() <= 1e-5, (step, k)
