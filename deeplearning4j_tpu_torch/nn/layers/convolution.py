"""Convolution family: Conv2D/1D, Deconv2D, SeparableConv2D, Subsampling
(pooling) 1D/2D, Upsampling 1D/2D, ZeroPadding 1D/2D (counterpart of
deeplearning4j_tpu/nn/layers/convolution.py).

ConvolutionMode semantics (Strict/Truncate/Same) follow
inputs.conv_output_size; 'same' is XLA 'SAME', which pads the odd pixel on
the high side (ops/linear.same_padding). 1-D layers work on [b, t, c] as
width-one 2-D ones.

Under the model axis a convolution holds its output channels' slice of
the kernel and bias (the Megatron column rule on HWIO's cout), convolves
the whole input into them and gathers the channels; SeparableConv2D
splits only its pointwise kernel, the depthwise one stays whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import initializers as init_mod
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    apply_dropout,
    column_parallel_specs,
    register_layer,
)
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


def _hwio_to_held(value):
    """An interchange HWIO kernel -> OIHW in channels_last memory."""
    return value.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _held_to_hwio(value):
    return value.permute(2, 3, 1, 0).contiguous()


# where each interchange (HWIO) dim of a held OIHW kernel is
HWIO_IN_OIHW = (2, 3, 1, 0)


def _split_out(z):
    """A convolution's output on a model split: this rank's channels
    gathered (the last dim of NHWC / BTC); the whole output otherwise."""
    tp = shard_mod.model_split()
    return z if tp is None else tp.gather(z, -1)


def _split_in(x):
    """The input of a model-split convolution: Megatron's f."""
    tp = shard_mod.model_split()
    return x if tp is None else tp.copy(x)


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

    computes_model_shards = True

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        """The output-channel split: HWIO's last axis is cout, so the
        column rule applies as it stands (Conv2D, Conv1D, Deconv2D)."""
        return column_parallel_specs(self.interchange(params), model_axis,
                                     model_size)

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
        return _hwio_to_held(value) if key == "W" else value

    def to_interchange(self, key, value):
        return _held_to_hwio(value) if key == "W" else value

    def interchange_dims(self, path):
        return HWIO_IN_OIHW if path == "W" else None

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        pad = _conv_padding(self.convolution_mode, self.padding)
        z = ops.conv2d(_split_in(x), params["W"], _pair(self.stride), pad,
                       _pair(self.dilation))
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        y = self.act_fn("identity")(_split_out(z))
        return apply_dropout(y, self.dropout, train, rng), state


@register_layer
@dataclass
class Conv1D(Conv2D):
    """1D conv over [b, t, c] (DL4J Convolution1DLayer: a width-one 2D
    conv). Interchange kernel [k, 1, cin, cout], held as Conv2D holds its
    own."""

    def _1d(self):
        return (_pair(self.kernel_size)[0], _pair(self.stride)[0],
                _pair(self.padding)[0], _pair(self.dilation)[0])

    def output_type(self, input_type):
        k, s, p, d = self._1d()
        t = input_type.timesteps
        ot = (it.conv_output_size(t, k, s, p, self.convolution_mode, d)
              if t > 0 else -1)
        return it.Recurrent(self.n_out, ot)

    def init_params(self, gen, input_type):
        cin = self.n_in or input_type.size
        k = self._1d()[0]
        w = init_mod.init(self.weight_init or "xavier", gen,
                          (k, 1, cin, self.n_out), fan_in=cin * k,
                          fan_out=self.n_out * k, distribution=self.dist)
        p = {"W": self.from_interchange("W", w)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0))
        return p

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        k, s, p, d = self._1d()
        pad = "SAME" if self.convolution_mode == "same" else [(p, p), (0, 0)]
        z = ops.conv2d(_split_in(x)[:, :, None, :], params["W"], (s, 1), pad,
                       (d, 1))
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        y = self.act_fn("identity")(_split_out(z[:, :, 0, :]))
        return apply_dropout(y, self.dropout, train, rng), state


@register_layer
@dataclass
class Deconv2D(_ConvBase):
    """Transposed convolution (nn/conf/layers/Deconvolution2D.java). The
    kernel is held in the interchange layout, HWIO [kh, kw, cin, cout]
    (`ops.conv2d_transpose`). `output_type` declares what the JAX
    package's declares; `apply` computes what its `apply` computes. Under
    explicit padding the two differ (ROADMAP C.15): k 4, stride 2, pad 1
    on 5x5 declares 10x10 and computes 8x8."""

    def output_type(self, input_type):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        h, w = input_type.height, input_type.width
        if self.convolution_mode == "same":
            oh, ow = h * sh, w * sw
        else:
            oh = sh * (h - 1) + kh - 2 * ph
            ow = sw * (w - 1) + kw - 2 * pw
        return it.Convolutional(oh, ow, self.n_out)

    def init_params(self, gen, input_type):
        cin = self.n_in or input_type.channels
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_mod.init(self.weight_init or "xavier", gen,
                                (kh, kw, cin, self.n_out),
                                fan_in=cin * kh * kw,
                                fan_out=self.n_out * kh * kw,
                                distribution=self.dist)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0))
        return p

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        ph, pw = _pair(self.padding)
        if self.convolution_mode == "same":
            pad = "SAME"
        else:
            pad = [(ph, ph), (pw, pw)] if (ph or pw) else "VALID"
        z = ops.conv2d_transpose(_split_in(x), params["W"],
                                 _pair(self.stride), pad)
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        return self.act_fn("identity")(_split_out(z)), state


@register_layer
@dataclass
class SeparableConv2D(_ConvBase):
    """Depthwise + pointwise conv (nn/conf/layers/
    SeparableConvolution2D.java): `depth_multiplier` channels per input
    channel (interchange dW [kh, kw, 1, cin * depth_multiplier], a conv of
    cin groups), then a 1x1 mix (pW [1, 1, cin * depth_multiplier,
    n_out]). Both are held as Conv2D holds its kernel."""

    depth_multiplier: int = 1

    def output_type(self, input_type):
        oh, ow = self._spatial_out(input_type.height, input_type.width)
        return it.Convolutional(oh, ow, self.n_out)

    def init_params(self, gen, input_type):
        cin = self.n_in or input_type.channels
        kh, kw = _pair(self.kernel_size)
        dm = self.depth_multiplier
        wi = self.weight_init or "xavier"
        dw = init_mod.init(wi, gen, (kh, kw, 1, cin * dm), fan_in=kh * kw,
                           fan_out=dm * kh * kw, distribution=self.dist)
        pw = init_mod.init(wi, gen, (1, 1, cin * dm, self.n_out),
                           fan_in=cin * dm, fan_out=self.n_out,
                           distribution=self.dist)
        p = {"dW": self.from_interchange("dW", dw),
             "pW": self.from_interchange("pW", pw)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0))
        return p

    def from_interchange(self, key, value):
        return _hwio_to_held(value) if key in ("dW", "pW") else value

    def to_interchange(self, key, value):
        return _held_to_hwio(value) if key in ("dW", "pW") else value

    def interchange_dims(self, path):
        return HWIO_IN_OIHW if path in ("dW", "pW") else None

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        """The pointwise 1x1 mix (where the FLOPs are) split on its output
        channels, the bias with it; the depthwise kernel stays whole."""
        specs = {k: () for k in params}
        pw = params.get("pW")
        if model_size > 1 and pw is not None:
            n_out = pw.shape[0]  # held OIHW: cout leads
            if n_out % model_size == 0 and n_out >= 2 * model_size:
                specs["pW"] = (None, None, None, model_axis)
                if "b" in params:
                    specs["b"] = (model_axis,)
        return specs

    def regularizable(self, params):
        return {k: v for k, v in params.items() if k in ("dW", "pW")}

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        pad = _conv_padding(self.convolution_mode, self.padding)
        z = ops.conv2d(x, params["dW"], _pair(self.stride), pad,
                       _pair(self.dilation), groups=x.shape[-1])
        z = ops.conv2d(_split_in(z), params["pW"], (1, 1), "VALID")
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        return self.act_fn("identity")(_split_out(z)), state


def _pool_nhwc(x, k, s, pads, pooling_type: str, pnorm: int = 2):
    """Windowed pooling of an NHWC tensor as the JAX package's
    lax.reduce_window: explicit (lo, hi) pads, -inf for max and 0 for the
    sums, so avg divides by the full window with padded cells counted.
    pnorm is (sum |x|^p)^(1/p); its gradient over an all-zero window is NaN
    (0 ** (1/p)), as in JAX."""
    pt = pooling_type.lower()
    if pt == "max":
        xp = ops.pad_nhwc(x, pads, value=float("-inf"))
        y = F.max_pool2d(xp.permute(0, 3, 1, 2), k, s)
    elif pt in ("avg", "mean", "sum"):
        xp = ops.pad_nhwc(x, pads)
        y = F.avg_pool2d(xp.permute(0, 3, 1, 2), k, s,
                         divisor_override=None if pt != "sum" else 1)
    elif pt == "pnorm":
        p = float(pnorm)
        xp = ops.pad_nhwc(torch.abs(x) ** p, pads)
        y = F.avg_pool2d(xp.permute(0, 3, 1, 2), k, s,
                         divisor_override=1) ** (1.0 / p)
    else:
        raise ValueError(f"Unknown pooling type {pooling_type}")
    return y.permute(0, 2, 3, 1).contiguous()


@register_layer
@dataclass
class Subsampling2D(Layer):
    """Pooling over NHWC: MAX / AVG / SUM / PNORM
    (nn/conf/layers/SubsamplingLayer.java), through `_pool_nhwc`."""

    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pooling_type: str = "max"  # max | avg | sum | pnorm
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

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        k = _pair(self.kernel_size)
        s = _pair(self.stride)
        pads = ops.resolve_padding(
            x, k, s, _conv_padding(self.convolution_mode, self.padding))
        return _pool_nhwc(x, k, s, pads, self.pooling_type,
                          self.pnorm), state


@register_layer
@dataclass
class Subsampling1D(Layer):
    """1D pooling over [b, t, c] (nn/conf/layers/Subsampling1DLayer.java):
    max, else avg (the sum over the window, pads included, divided by k)."""

    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = "truncate"
    pooling_type: str = "max"

    def has_params(self):
        return False

    def output_type(self, input_type):
        t = input_type.timesteps
        ot = (it.conv_output_size(t, int(self.kernel_size), int(self.stride),
                                  int(self.padding), self.convolution_mode)
              if t > 0 else -1)
        return it.Recurrent(input_type.size, ot)

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        k, s, p = int(self.kernel_size), int(self.stride), int(self.padding)
        x4 = x[:, :, None, :]
        pads = ops.resolve_padding(
            x4, (k, 1), (s, 1),
            "SAME" if self.convolution_mode == "same" else [(p, p), (0, 0)])
        pt = "max" if self.pooling_type.lower() == "max" else "avg"
        return _pool_nhwc(x4, (k, 1), (s, 1), pads, pt)[:, :, 0, :], state


@register_layer
@dataclass
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling (nn/conf/layers/Upsampling2D.java)."""

    size: Tuple[int, int] = (2, 2)

    def has_params(self):
        return False

    def output_type(self, input_type):
        sh, sw = _pair(self.size)
        return it.Convolutional(input_type.height * sh,
                                input_type.width * sw, input_type.channels)

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(
            sw, dim=2), state


@register_layer
@dataclass
class Upsampling1D(Layer):
    """Nearest-neighbour upsampling of [b, t, c] along t."""

    size: int = 2

    def has_params(self):
        return False

    def output_type(self, input_type):
        t = input_type.timesteps
        return it.Recurrent(input_type.size,
                            t * int(self.size) if t > 0 else -1)

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return x.repeat_interleave(int(self.size), dim=1), state


@register_layer
@dataclass
class ZeroPadding2D(Layer):
    """(nn/conf/layers/ZeroPaddingLayer.java) pad = (top, bottom, left,
    right); an int pads every side, a pair (rows, columns)."""

    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def has_params(self):
        return False

    def _p(self):
        p = self.pad
        if isinstance(p, int):
            return (p, p, p, p)
        if len(p) == 2:
            return (p[0], p[0], p[1], p[1])
        return tuple(p)

    def output_type(self, input_type):
        t, b, l, r = self._p()
        return it.Convolutional(input_type.height + t + b,
                                input_type.width + l + r, input_type.channels)

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        t, b, l, r = self._p()
        return ops.pad_nhwc(x, [(t, b), (l, r)]), state


@register_layer
@dataclass
class ZeroPadding1D(Layer):
    """Zero padding of [b, t, c] along t: pad = (left, right), or an int
    for both."""

    pad: Tuple[int, int] = (0, 0)

    def has_params(self):
        return False

    def _p(self):
        p = self.pad
        return (p, p) if isinstance(p, int) else tuple(p)

    def output_type(self, input_type):
        l, r = self._p()
        t = input_type.timesteps
        return it.Recurrent(input_type.size, t + l + r if t > 0 else -1)

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        l, r = self._p()
        return F.pad(x, (0, 0, l, r)), state
