"""Yolo2Output: the YOLOv2 detection loss layer, and the host-side decode
(counterpart of deeplearning4j_tpu/nn/layers/objdetect.py).

Reference: nn/conf/layers/objdetect/Yolo2OutputLayer.java and its runtime
(lambda_coord / lambda_no_obj weighting, the responsible anchor chosen by
IoU, sqrt-wh coordinate loss, IoU confidence targets, per-cell softmax
class loss).

Label format, NHWC:
    labels [b, gridH, gridW, 4 + C]
      [..., 0:2] = object top-left (x, y), normalized image coords
      [..., 2:4] = object bottom-right (x, y), normalized
      [..., 4:]  = one-hot class; a cell with no object is all zeros.

The layer's input is [b, gridH, gridW, B * (5 + C)] raw activations; per
anchor (tx, ty, tw, th, to) and C class logits. sigmoid(tx, ty) is the
in-cell offset, the anchor's (w, h) scale exp(tw, th).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn import losses as loss_mod
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.output import BaseOutputLayer


@register_layer
@dataclass
class Yolo2Output(BaseOutputLayer, Layer):
    boxes: Optional[List[List[float]]] = None  # anchor (w, h) in grid units
    num_classes: int = 0
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def has_params(self):
        return False

    def output_type(self, input_type):
        return input_type

    def _split(self, x):
        """x [b, H, W, B * (5 + C)] -> tx, ty, tw, th, conf [b, H, W, B],
        class logits [b, H, W, B, C]."""
        b, H, W, _ = x.shape
        x = x.reshape(b, H, W, len(self.boxes), 5 + self.num_classes)
        return (x[..., 0], x[..., 1], x[..., 2], x[..., 3], x[..., 4],
                x[..., 5:])

    def _pred_boxes(self, x):
        """Centers (x, y) and sizes (w, h) in grid units, objectness and
        class probabilities."""
        tx, ty, tw, th, to, tc = self._split(x)
        H, W = tx.shape[1:3]
        anchors = torch.tensor(self.boxes, dtype=x.dtype, device=x.device)
        cx = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :,
                                                              None]
        cy = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None,
                                                              None]
        px = torch.sigmoid(tx) + cx
        py = torch.sigmoid(ty) + cy
        pw = anchors[:, 0] * torch.exp(tw)
        ph = anchors[:, 1] * torch.exp(th)
        return (px, py, pw, ph, torch.sigmoid(to),
                torch.softmax(tc, dim=-1))

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return x, state

    def compute_loss(self, params, x, labels, *, state, mask=None):
        b, H, W, _ = x.shape
        B = len(self.boxes)
        px, py, pw, ph, conf, _ = self._pred_boxes(x)
        tx_, ty_, _, _, _, tc_ = self._split(x)

        # ground truth per cell, in grid units
        scale = torch.tensor([W, H], dtype=x.dtype, device=x.device)
        tl = labels[..., 0:2] * scale
        br = labels[..., 2:4] * scale
        gt_wh = br - tl
        gt_center = 0.5 * (tl + br)
        obj = (labels[..., 4:].sum(dim=-1) > 0).to(x.dtype)  # [b, H, W]

        # IoU of each anchor's prediction with the cell's box
        gw, gh = gt_wh[..., 0:1], gt_wh[..., 1:2]
        gcx, gcy = gt_center[..., 0:1], gt_center[..., 1:2]
        iw = (torch.minimum(px + pw / 2, gcx + gw / 2)
              - torch.maximum(px - pw / 2, gcx - gw / 2)).clamp_min(0.0)
        ih = (torch.minimum(py + ph / 2, gcy + gh / 2)
              - torch.maximum(py - ph / 2, gcy - gh / 2)).clamp_min(0.0)
        inter = iw * ih
        union = pw * ph + gw * gh - inter
        iou = inter / union.clamp_min(1e-9)  # [b, H, W, B]

        # the responsible anchor: the first of the largest IoUs, as
        # jnp.argmax takes it
        best = torch.nn.functional.one_hot(_first_argmax(iou), B).to(x.dtype)
        resp = best * obj[..., None]

        off_x = gt_center[..., 0] - torch.floor(gt_center[..., 0])
        off_y = gt_center[..., 1] - torch.floor(gt_center[..., 1])
        l_xy = resp * ((torch.sigmoid(tx_) - off_x[..., None]) ** 2
                       + (torch.sigmoid(ty_) - off_y[..., None]) ** 2)
        l_wh = resp * (
            (pw.clamp_min(1e-9).sqrt() - gw.clamp_min(1e-9).sqrt()) ** 2
            + (ph.clamp_min(1e-9).sqrt() - gh.clamp_min(1e-9).sqrt()) ** 2)
        l_conf_obj = resp * (conf - iou.detach()) ** 2
        l_conf_noobj = (1.0 - resp) * conf ** 2
        logp = torch.log_softmax(tc_, dim=-1)
        l_cls = resp * -(labels[..., None, 4:] * logp).sum(dim=-1)

        dims = (1, 2, 3)
        per_image = (self.lambda_coord * (l_xy + l_wh).sum(dim=dims)
                     + l_conf_obj.sum(dim=dims)
                     + self.lambda_no_obj * l_conf_noobj.sum(dim=dims)
                     + l_cls.sum(dim=dims))
        # the mean over the images, in a data-parallel step this rank's
        # share of the global batch's mean
        score, per_image = loss_mod.reduce_score(per_image)
        return score, per_image, state

    def decode_predictions(self, x, conf_threshold: float = 0.5):
        """Per image, a list of (x1, y1, x2, y2, confidence, class_id) in
        normalized coordinates, objectness above `conf_threshold`: the
        tuple view of `get_predicted_objects`."""
        H, W = x.shape[1:3]
        out = [[] for _ in range(x.shape[0])]
        for d in get_predicted_objects(self, x, conf_threshold):
            x1, y1 = d.top_left()
            x2, y2 = d.bottom_right()
            out[d.example].append((x1 / W, y1 / H, x2 / W, y2 / H,
                                   d.confidence, d.predicted_class))
        return out


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis, a NaN counting as
    the largest value, as jnp.argmax takes it (torch.argmax does not
    promise which of tied maxima it returns on the card)."""
    n = v.shape[-1]
    ar = torch.arange(n, device=v.device)
    is_max = (v == v.amax(dim=-1, keepdim=True)) | v.isnan()
    return torch.where(is_max, ar, n).amin(dim=-1)


@dataclass
class DetectedObject:
    """One detection in grid units (nn/layers/objdetect/
    DetectedObject.java): center (x, y), size (w, h), class, confidence."""

    example: int
    center_x: float
    center_y: float
    width: float
    height: float
    predicted_class: int
    confidence: float
    class_probabilities: Optional[List[float]] = None

    def top_left(self):
        return self.center_x - self.width / 2, self.center_y - self.height / 2

    def bottom_right(self):
        return self.center_x + self.width / 2, self.center_y + self.height / 2


def _iou(a: DetectedObject, b: DetectedObject) -> float:
    ax1, ay1 = a.top_left()
    ax2, ay2 = a.bottom_right()
    bx1, by1 = b.top_left()
    bx2, by2 = b.bottom_right()
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a.width * a.height + b.width * b.height - inter
    return inter / union if union > 0 else 0.0


def get_predicted_objects(layer: Yolo2Output, network_output,
                          threshold: float = 0.5) -> List[DetectedObject]:
    """Detections with objectness above `threshold` (YoloUtils.
    getPredictedObjects), in grid units, in the order of (image, row,
    column, anchor). The decode and the threshold run where the output
    lies; only the kept anchors are copied to the host."""
    x = torch.as_tensor(network_output)
    if x.dtype == torch.float64:  # jnp.asarray's float32
        x = x.float()
    with torch.no_grad():
        px, py, pw, ph, conf, cls_prob = layer._pred_boxes(x)
        idx = torch.nonzero(conf > threshold)  # row-major, as np.nonzero
        b, i, j, a = idx.unbind(dim=1)
        kept = torch.stack([px[b, i, j, a], py[b, i, j, a], pw[b, i, j, a],
                            ph[b, i, j, a], conf[b, i, j, a]], dim=1)
        probs = cls_prob[b, i, j, a]
        idx, kept, probs = (t.cpu().numpy() for t in (idx, kept, probs))
    return [DetectedObject(
        example=int(idx[n, 0]), center_x=float(kept[n, 0]),
        center_y=float(kept[n, 1]), width=float(kept[n, 2]),
        height=float(kept[n, 3]), predicted_class=int(probs[n].argmax()),
        confidence=float(kept[n, 4]),
        class_probabilities=[float(v) for v in probs[n]])
        for n in range(len(idx))]


def non_max_suppression(objs: List[DetectedObject],
                        iou_threshold: float = 0.5) -> List[DetectedObject]:
    """Greedy per-class NMS (YoloUtils.nms): keep the most confident
    boxes, drop same-image, same-class overlaps above `iou_threshold`."""
    keep: List[DetectedObject] = []
    for o in sorted(objs, key=lambda d: -d.confidence):
        if all(not (k.example == o.example
                    and k.predicted_class == o.predicted_class
                    and _iou(k, o) > iou_threshold)
               for k in keep):
            keep.append(o)
    return keep
