"""Feed-forward layers: Dense, ElementWiseMultiplication, Activation,
DropoutLayer, Embedding and EmbeddingSequence (counterpart of
deeplearning4j_tpu/nn/layers/dense.py).

Params follow DL4J naming: W [nIn, nOut], b [nOut] — the same layout in
both packages. Under the model axis Dense, Embedding and EmbeddingSequence
hold a column slice of W and b (`column_parallel_specs`), compute their
output slice and gather it before the activation (`nn.shard`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

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


def _flatten_if_needed(x):
    """CNN input into a dense layer is flattened (NHWC order, as the JAX
    package does); 3d [b,t,f] input stays, the matmul runs per timestep."""
    if x.dim() == 4:
        return x.reshape(x.shape[0], -1)
    return x


@register_layer
@dataclass
class Dense(Layer):
    """Fully connected: y = act(x @ W + b)."""

    sp_safe = True  # per-timestep matmul: time sharding is transparent

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True

    computes_model_shards = True

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        return column_parallel_specs(params, model_axis, model_size)

    def output_type(self, input_type):
        if isinstance(input_type, it.Recurrent):
            return it.Recurrent(self.n_out, input_type.timesteps)
        return it.FeedForward(self.n_out)

    def resolve_n_in(self, input_type):
        if self.n_in:
            return self.n_in
        if isinstance(input_type, it.Recurrent):
            return input_type.size
        return input_type.arity()

    def init_params(self, gen, input_type):
        n_in = self.resolve_n_in(input_type)
        p = {"W": init_mod.init(self.weight_init or "xavier", gen,
                                (n_in, self.n_out), distribution=self.dist)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0))
        return p

    def preout(self, params, x):
        z = ops.dot(_flatten_if_needed(x), params["W"])
        if self.has_bias:
            z = ops.bias_add(z, params["b"])
        return z

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        tp = shard_mod.model_split()
        if tp is None:
            z = self.preout(params, x)
        else:  # W's column slice: this rank's output features, gathered
            z = tp.gather(self.preout(params, tp.copy(x)), -1)
        y = self.act_fn("sigmoid")(z)
        return apply_dropout(y, self.dropout, train, rng), state


@register_layer
@dataclass
class ElementWiseMultiplication(Layer):
    """y = act(x * W + b), W and b shaped [n_out] (nn/conf/layers/misc/
    ElementWiseMultiplicationLayer.java); W starts at ones, b at zeros."""

    sp_safe = True  # elementwise

    n_in: Optional[int] = None
    n_out: int = 0

    def output_type(self, input_type):
        return it.FeedForward(self.n_out or input_type.arity())

    def init_params(self, gen, input_type):
        n = self.n_out or input_type.arity()
        return {"W": torch.ones(n), "b": torch.zeros(n)}

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return self.act_fn("identity")(x * params["W"] + params["b"]), state


@register_layer
@dataclass
class Activation(Layer):
    """Parameterless activation layer (nn/conf/layers/ActivationLayer.java)."""

    sp_safe = True  # elementwise

    def output_type(self, input_type):
        return input_type

    def has_params(self):
        return False

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return self.act_fn("identity")(x), state


@register_layer
@dataclass
class DropoutLayer(Layer):
    """Standalone dropout (nn/conf/layers/DropoutLayer.java): `dropout`
    (a retain probability, DL4J-style, or an IDropout) on its input at train
    time, the identity at inference."""

    sp_safe = True  # elementwise

    def output_type(self, input_type):
        return input_type

    def has_params(self):
        return False

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return apply_dropout(x, self.dropout, train, rng), state


def _lookup(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rows of `table` at ids `x`, as the JAX package's
    `jnp.take(W, x.astype(int32), axis=0)`: ids of any numeric dtype
    truncate toward zero, ids in [-n, 0) count from the end, and ids out
    of range give NaN rows (jnp.take's "fill" mode). A server then refuses
    the batch as non-finite; an unchecked gather would raise on the CPU and
    assert on the device, which loses the process's CUDA context."""
    n = table.shape[0]
    idx = x.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    y = torch.nn.functional.embedding(idx.clamp(0, n - 1), table)
    return y.masked_fill(~valid[..., None], float("nan"))


@register_layer
@dataclass
class Embedding(Layer):
    """Index lookup: ids [b] or [b, 1] -> [b, n_out], plus a bias after the
    lookup when has_bias (DL4J EmbeddingLayer)."""

    n_in: Optional[int] = None  # vocab size
    n_out: int = 0
    has_bias: bool = True

    computes_model_shards = True

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        # the embedding dim split: a lookup keeps rows whole, each rank
        # holds its slice of every row
        return column_parallel_specs(params, model_axis, model_size)

    def output_type(self, input_type):
        return it.FeedForward(self.n_out)

    def init_params(self, gen, input_type):
        n_in = self.n_in or input_type.arity()
        p = {"W": init_mod.init(self.weight_init or "xavier", gen,
                                (n_in, self.n_out), distribution=self.dist)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0))
        return p

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        if x.dim() == 2 and x.shape[-1] == 1:
            x = x[:, 0]
        return self.act_fn("identity")(_embed(self, params, x)), state


def _embed(layer, params, x):
    """The lookup plus bias; on a model split, this rank's columns
    gathered."""
    y = _lookup(params["W"], x)
    if layer.has_bias:
        y = ops.bias_add(y, params["b"])
    tp = shard_mod.model_split()
    return y if tp is None else tp.gather(y, -1)


@register_layer
@dataclass
class EmbeddingSequence(Layer):
    """Sequence embedding: ids [b, t] -> [b, t, n_out] (BTF layout)."""

    sp_safe = True  # per-token gather

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = False

    computes_model_shards = True

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        return column_parallel_specs(params, model_axis, model_size)

    def output_type(self, input_type):
        t = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(self.n_out, t)

    def init_params(self, gen, input_type):
        n_in = self.n_in or input_type.size
        p = {"W": init_mod.init(self.weight_init or "xavier", gen,
                                (n_in, self.n_out), distribution=self.dist)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out)
        return p

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return self.act_fn("identity")(_embed(self, params, x)), state
