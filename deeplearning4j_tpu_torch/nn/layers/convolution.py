"""Convolution family, the part ResNet-50 runs: Conv2D and Subsampling2D
(counterpart of deeplearning4j_tpu/nn/layers/convolution.py; Conv1D,
Deconv2D, SeparableConv2D, the 1D pools, upsampling and zero padding come
with later slices).

ConvolutionMode semantics (Strict/Truncate/Same) follow
inputs.conv_output_size; 'same' is XLA 'SAME', which pads the odd pixel on
the high side (ops/linear.same_padding).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import initializers as init_mod
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops import linear as ops


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def _conv_padding(mode: str, padding):
    """ConvolutionMode + explicit pad -> an ops.linear padding spec."""
    if mode == "same":
        return "SAME"
    ph, pw = _pair(padding)
    return [(ph, ph), (pw, pw)]


@dataclass
class _ConvBase(Layer):
    kernel_size: Tuple[int, int] = (1, 1)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"  # strict | truncate | same
    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True

    def _spatial_out(self, h, w):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        m = self.convolution_mode
        oh = it.conv_output_size(h, kh, sh, ph, m, dh)
        ow = it.conv_output_size(w, kw, sw, pw, m, dw)
        return oh, ow


@register_layer
@dataclass
class Conv2D(_ConvBase):
    """2D convolution. Interchange kernel HWIO [kh, kw, cin, cout]; held as
    OIHW [cout, cin, kh, kw] in channels_last memory, the layout cuDNN
    takes for an NHWC activation without transposing it."""

    def output_type(self, input_type):
        if not isinstance(input_type, it.Convolutional):
            raise ValueError(f"Conv2D needs CNN input, got {input_type}")
        oh, ow = self._spatial_out(input_type.height, input_type.width)
        return it.Convolutional(oh, ow, self.n_out)

    def init_params(self, gen, input_type):
        cin = self.n_in or input_type.channels
        kh, kw = _pair(self.kernel_size)
        w = init_mod.init(self.weight_init or "xavier", gen,
                          (kh, kw, cin, self.n_out), fan_in=cin * kh * kw,
                          fan_out=self.n_out * kh * kw,
                          distribution=self.dist)
        p = {"W": self.from_interchange("W", w)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0))
        return p

    def from_interchange(self, key, value):
        if key == "W":  # HWIO -> OIHW, channels_last
            return value.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return value

    def to_interchange(self, key, value):
        if key == "W":  # OIHW -> HWIO
            return value.permute(2, 3, 1, 0).contiguous()
        return value

    def apply(self, params, x, *, state, train, mask=None):
        pad = _conv_padding(self.convolution_mode, self.padding)
        z = ops.conv2d(x, params["W"], _pair(self.stride), pad,
                       _pair(self.dilation))
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        return self.act_fn("identity")(z), state


@register_layer
@dataclass
class Subsampling2D(Layer):
    """Pooling over NHWC (nn/conf/layers/SubsamplingLayer.java): MAX and AVG
    (SUM and PNORM come with a later slice). Padding is explicit, with -inf
    for MAX, so 'same' pads like XLA's reduce_window and AVG divides by the
    full window, padded cells included, as the JAX package does."""

    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pooling_type: str = "max"  # max | avg
    pnorm: int = 2

    def has_params(self):
        return False

    def output_type(self, input_type):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        oh = it.conv_output_size(input_type.height, kh, sh, ph, self.convolution_mode)
        ow = it.conv_output_size(input_type.width, kw, sw, pw, self.convolution_mode)
        return it.Convolutional(oh, ow, input_type.channels)

    def apply(self, params, x, *, state, train, mask=None):
        k = _pair(self.kernel_size)
        s = _pair(self.stride)
        pt = self.pooling_type.lower()
        pads = ops.resolve_padding(
            x, k, s, _conv_padding(self.convolution_mode, self.padding))
        if pt == "max":
            xp = ops.pad_nhwc(x, pads, value=float("-inf"))
            y = F.max_pool2d(xp.permute(0, 3, 1, 2), k, s)
        elif pt in ("avg", "mean"):
            xp = ops.pad_nhwc(x, pads)
            y = F.avg_pool2d(xp.permute(0, 3, 1, 2), k, s)
        else:
            raise NotImplementedError(
                f"Subsampling2D pooling_type {self.pooling_type!r} is not "
                f"ported yet (max, avg are)")
        return y.permute(0, 2, 3, 1).contiguous(), state
