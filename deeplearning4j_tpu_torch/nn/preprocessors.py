"""Input preprocessors: shape adapters between layer families (counterpart of
deeplearning4j_tpu/nn/preprocessors.py, in full).

Each preprocessor is a `transform` of a tensor plus its InputType map;
autograd reverses the reshapes. Layouts are the JAX package's: CNN
activations NHWC, RNN activations BTF, so `CnnToFeedForward` flattens in
NHWC order. The JSON of a preprocessor is the same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from deeplearning4j_tpu_torch.nn import inputs as it

_TYPES: Dict[str, type] = {}


def register_preprocessor(cls):
    _TYPES[cls.__name__] = cls
    return cls


class InputPreProcessor:
    def transform(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, input_type: it.InputType) -> it.InputType:
        raise NotImplementedError

    def transform_mask(self, mask, batch):
        return mask

    def to_json(self):
        d = {"type": type(self).__name__}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_json(d: dict) -> "InputPreProcessor":
        d = dict(d)
        cls = _TYPES[d.pop("type")]
        if cls is Composable:
            d["processors"] = [InputPreProcessor.from_json(p)
                               for p in d["processors"]]
        return cls(**d)


@register_preprocessor
@dataclass
class CnnToFeedForward(InputPreProcessor):
    """[b,h,w,c] -> [b, h*w*c]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def transform(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        return it.FeedForward(input_type.arity())


@register_preprocessor
@dataclass
class FeedForwardToCnn(InputPreProcessor):
    """[b, h*w*c] -> [b,h,w,c]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def transform(self, x, mask=None):
        if x.ndim == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return it.Convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclass
class CnnToRnn(InputPreProcessor):
    """[b,h,w,c] -> [b, t=h, f=w*c]: the rows are the time steps."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def transform(self, x, mask=None):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)

    def output_type(self, input_type):
        return it.Recurrent(input_type.width * input_type.channels,
                            input_type.height)


@register_preprocessor
@dataclass
class CnnToTokens(InputPreProcessor):
    """[b,h,w,c] -> [b, t=h*w, f=c]: spatial positions become sequence
    tokens (the ViT patch-embedding adapter)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def transform(self, x, mask=None):
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)

    def output_type(self, input_type):
        return it.Recurrent(input_type.channels,
                            input_type.height * input_type.width)


@register_preprocessor
@dataclass
class RnnToCnn(InputPreProcessor):
    """[b, t, f] -> [b*t, h, w, c]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def transform(self, x, mask=None):
        b, t, f = x.shape
        return x.reshape(b * t, self.height, self.width, self.channels)

    def output_type(self, input_type):
        return it.Convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclass
class FeedForwardToRnn(InputPreProcessor):
    """Identity: networks keep [b, t, f] 3d all the way; kept for config
    parity."""

    def transform(self, x, mask=None):
        return x

    def output_type(self, input_type):
        if isinstance(input_type, it.Recurrent):
            return input_type
        return it.Recurrent(input_type.arity())


@register_preprocessor
@dataclass
class RnnToFeedForward(InputPreProcessor):
    """Identity: [b, t, f] stays 3d (dense layers apply per time step);
    kept for config parity."""

    def transform(self, x, mask=None):
        return x

    def output_type(self, input_type):
        return input_type


@register_preprocessor
@dataclass
class ReshapePreprocessor(InputPreProcessor):
    """Reshape each example to `target_shape` (batch dim kept): the Keras
    Reshape layer."""

    target_shape: tuple = ()

    def transform(self, x, mask=None):
        return x.reshape((x.shape[0],) + tuple(self.target_shape))

    def output_type(self, input_type):
        dims = list(self.target_shape)
        if len(dims) == 1:
            return it.FeedForward(dims[0])
        if len(dims) == 2:
            return it.Recurrent(dims[1], dims[0])
        if len(dims) == 3:
            return it.Convolutional(dims[0], dims[1], dims[2])
        raise ValueError(f"cannot reshape to {self.target_shape}")


@register_preprocessor
@dataclass
class Composable(InputPreProcessor):
    processors: list = field(default_factory=list)

    def transform(self, x, mask=None):
        for p in self.processors:
            x = p.transform(x, mask)
        return x

    def output_type(self, input_type):
        for p in self.processors:
            input_type = p.output_type(input_type)
        return input_type

    def to_json(self):
        return {"type": "Composable",
                "processors": [p.to_json() for p in self.processors]}
