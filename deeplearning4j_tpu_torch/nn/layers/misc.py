"""The Frozen wrapper (counterpart of deeplearning4j_tpu/nn/layers/misc.py;
nn/conf/layers/misc/FrozenLayer.java, runtime nn/layers/FrozenLayer.java):
the wrapped layer's forward with train=False (BatchNorm on its running
statistics, no dropout), no l1/l2 penalty, and no update: the runtimes
read the `frozen` marker (MultiLayerNetwork leaves the layer's params out
of the gradient and out of the updater). Its JSON nests the wrapped
layer's under `underlying`, as the JAX package writes it, so checkpoints
of either package and `from_json` read it. The param layout is the
wrapped layer's (Conv2D's OIHW inside, HWIO in the interchange form).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclass
class Frozen(Layer):
    underlying: Optional[Union[dict, Layer]] = None

    frozen = True

    def __post_init__(self):
        if isinstance(self.underlying, Layer):
            self._inner = self.underlying
        elif isinstance(self.underlying, dict):
            self._inner = Layer.from_json(self.underlying)
        else:
            self._inner = None

    @property
    def inner(self) -> Layer:
        return self._inner

    def output_type(self, input_type):
        return self._inner.output_type(input_type)

    def init_params(self, gen, input_type):
        return self._inner.init_params(gen, input_type)

    def init_state(self, input_type):
        return self._inner.init_state(input_type)

    def has_params(self):
        return self._inner.has_params()

    def regularizable(self, params):
        return {}

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        # train=False for the wrapped layer: BN uses running stats, no dropout
        return self._inner.apply(params, x, state=state, train=False,
                                 mask=mask, rng=rng)

    def propagate_mask(self, mask, input_type):
        return self._inner.propagate_mask(mask, input_type)

    def from_interchange(self, key, value):
        return self._inner.from_interchange(key, value)

    def to_interchange(self, key, value):
        return self._inner.to_interchange(key, value)

    def to_json(self):
        d = {"type": "Frozen"}
        if self._inner is not None:
            d["underlying"] = self._inner.to_json()
        return d
