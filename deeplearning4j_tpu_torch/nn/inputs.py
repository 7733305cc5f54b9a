"""InputType shape inference (the port's own copy of
deeplearning4j_tpu/nn/inputs.py, which is plain Python).

Mirrors nn/conf/inputs/InputType.java (FF / RNN / CNN / CNNFlat) and
InputTypeUtil.java — every layer config maps an input type to its output type
so a network config can be fully shape-checked before any array exists
(`setInputType` propagation in MultiLayerConfiguration).

Layout conventions, shared with the JAX package (differ from DL4J):
  - CNN activations:  NHWC  (batch, height, width, channels); inside Conv2D
    the port hands cuDNN an NCHW view of the same memory, which is
    channels_last (DL4J/ND4J use NCHW).
  - RNN activations:  BTF   (batch, time, features)          (DL4J uses [b, f, t]).
  - FF activations:   [batch, features].
Keras import and any DL4J-format interop transpose at the boundary.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


class InputType:
    kind: str = "base"

    def shape(self, batch: int = -1) -> Tuple[int, ...]:
        raise NotImplementedError

    def arity(self) -> int:
        """Total features per example (flattened size)."""
        raise NotImplementedError

    def rank(self) -> int:
        """Array rank including the batch dim (NHWC/BTF layouts) — what
        the analyzer reports in vertex-boundary diagnostics (DLA005)."""
        return len(self.shape())

    def to_json(self) -> dict:
        d = {"kind": self.kind}
        d.update(self.__dict__)
        return d

    def __repr__(self):
        fields = ", ".join(f"{k}={v}" for k, v in self.__dict__.items())
        return f"InputType.{self.kind}({fields})"


@dataclass(repr=False)
class FeedForward(InputType):
    size: int
    kind: str = "ff"

    def shape(self, batch=-1):
        return (batch, self.size)

    def arity(self):
        return self.size


@dataclass(repr=False)
class Recurrent(InputType):
    size: int
    timesteps: int = -1  # -1 = variable (padded/bucketed at runtime)
    kind: str = "rnn"

    def shape(self, batch=-1):
        return (batch, self.timesteps, self.size)

    def arity(self):
        return self.size * max(self.timesteps, 1)


@dataclass(repr=False)
class Convolutional(InputType):
    height: int
    width: int
    channels: int
    kind: str = "cnn"

    def shape(self, batch=-1):
        return (batch, self.height, self.width, self.channels)

    def arity(self):
        return self.height * self.width * self.channels


@dataclass(repr=False)
class ConvolutionalFlat(InputType):
    height: int
    width: int
    channels: int
    kind: str = "cnn_flat"

    def shape(self, batch=-1):
        return (batch, self.height * self.width * self.channels)

    def arity(self):
        return self.height * self.width * self.channels


def feed_forward(size: int) -> FeedForward:
    return FeedForward(int(size))


def recurrent(size: int, timesteps: int = -1) -> Recurrent:
    return Recurrent(int(size), int(timesteps))


def convolutional(height: int, width: int, channels: int) -> Convolutional:
    return Convolutional(int(height), int(width), int(channels))


def convolutional_flat(height: int, width: int, channels: int) -> ConvolutionalFlat:
    return ConvolutionalFlat(int(height), int(width), int(channels))


_KINDS = {
    "ff": FeedForward,
    "rnn": Recurrent,
    "cnn": Convolutional,
    "cnn_flat": ConvolutionalFlat,
}


def from_json(d: dict) -> InputType:
    d = dict(d)
    kind = d.pop("kind")
    return _KINDS[kind](**d)


def conv_output_size(size: int, kernel: int, stride: int, pad: int,
                     mode: str = "truncate", dilation: int = 1) -> int:
    """Spatial output size, DL4J ConvolutionMode semantics
    (nn/conf/ConvolutionMode.java: Strict/Truncate/Same)."""
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    if mode == "same":
        return -(-size // stride)  # ceil
    out = (size + 2 * pad - eff_k) // stride + 1
    if mode == "strict":
        if (size + 2 * pad - eff_k) % stride != 0:
            raise ValueError(
                f"ConvolutionMode.Strict: (size={size} + 2*pad={pad} - k={eff_k}) "
                f"not divisible by stride={stride}"
            )
    return out
