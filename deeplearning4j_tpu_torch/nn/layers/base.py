"""Layer protocol: config + compute in one serializable object (counterpart
of deeplearning4j_tpu/nn/layers/base.py).

Each layer is ONE dataclass whose fields are its JSON config and whose
methods compute on tensors:

    output_type(input)            InputType propagation
    init_params(gen, input)       dict of CPU float32 tensors, in the port's
                                  layout, drawn from a torch.Generator
    init_state(input)             running state (BN stats); {} if none
    apply(params, x, *, state, train, mask, rng) -> (y, new_state)
    propagate_mask(mask, input)   the mask the next layer sees

Tensor parallelism (the model axis of `parallel.ParallelWrapper`): a
layer declares how its params split with `tensor_partition_specs` (the
JAX package's rule, as tuples of axis names over the interchange layout;
replicate by default). A layer with `computes_model_shards` runs on its
shards when one of them is split: `nn.shard.model_split()` gives it the
model axis inside `apply`, and it returns the whole output (Dense,
convolutions and embeddings gather their output slice; attention and the
FFN sum row-split products). Any other layer gets its split params
gathered whole before `apply` (the LSTMs, whose recurrence needs every
unit of h at every step, and the output layers, whose fused loss walks
the whole vocabulary).

`rng` is the layer's `nn.dropout.Draws` in a training step (None
elsewhere): a layer with `dropout` set applies it to its output through
`apply_dropout`; weight noise is applied to its params by the runtime
before `apply` (`nn.weightnoise.maybe_transform`).

Params are held as plain dicts of tensors per vertex, keyed by the JAX
package's names ("W", "b", "gamma", ...); a layer made of sublayers
(TransformerBlock) nests dicts the same way. Where the port keeps a param in
another memory layout than the interchange form (Conv2D holds OIHW weights
for cuDNN, the interchange form is HWIO), the layer converts in
`from_interchange` / `to_interchange`; nothing else knows the layout.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import dropout as drop_mod
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn import updaters as upd_mod
from deeplearning4j_tpu_torch.nn import weightnoise as wn_mod

Params = Dict[str, torch.Tensor]

_LAYER_TYPES: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator: adds the layer to the serde registry."""
    _LAYER_TYPES[cls.__name__] = cls
    return cls


@dataclass
class Layer:
    """Base layer config. The fields are the JAX package's, so a config's
    JSON reads the same in both packages. Training reads the updater,
    learning rate, l1/l2, gradient normalization, constraints, dropout,
    weight noise and the remat policy (`parallel.layout.maybe_remat`)."""

    # runs on its model shards (see the module docstring); False: its
    # split params are gathered whole before `apply`
    computes_model_shards = False

    # True when the layer computes per timestep (or is ring-aware), so the
    # seq axis of ParallelWrapper may shard its time axis and the result
    # is the unsharded one; layers that reduce or scan over time (LSTM,
    # pooling, 1-d convolutions) keep False and the wrapper refuses them
    sp_safe = False

    # --- per-layer overrides (None = inherit from NeuralNetConfiguration) ---
    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    updater: Optional[Any] = None          # Updater | str
    learning_rate: Optional[float] = None  # per-layer lr override
    dropout: Optional[Any] = None          # float retain-prob | dropout config
    weight_noise: Optional[Any] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    dist: Optional[dict] = None            # for weight_init == DISTRIBUTION
    constraints: Optional[list] = None
    remat: Optional[str] = None

    # ---- shape/param/compute protocol ----
    def output_type(self, input_type: it.InputType) -> it.InputType:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator,
                    input_type: it.InputType) -> Params:
        return {}

    def init_state(self, input_type: it.InputType) -> Params:
        return {}

    def apply(self, params: Params, x: torch.Tensor, *, state: Params,
              train: bool, mask: Optional[torch.Tensor] = None, rng=None
              ) -> Tuple[torch.Tensor, Params]:
        raise NotImplementedError

    def has_params(self) -> bool:
        return True

    def regularizable(self, params: Params) -> Params:
        """Params subject to l1/l2 weight decay (default: every key except
        biases)."""
        return {k: v for k, v in params.items() if not k.startswith("b")}

    def propagate_mask(self, mask: Optional[torch.Tensor],
                       input_type: it.InputType) -> Optional[torch.Tensor]:
        """The mask the next layer sees (DL4J feedForwardMaskArray);
        default passthrough."""
        return mask

    # ---- tensor parallelism ----
    def tensor_partition_specs(self, params: Params, model_axis: str = "model",
                               model_size: int = 1):
        """How the params split over the model axis: a tree of tuples (a
        JAX PartitionSpec's entries) over each param's interchange layout,
        the same structure as `params`. Default: replicate everything."""
        return upd_mod.tree_map(lambda _: (), params)

    def interchange_dims(self, path: str):
        """The port dim each interchange dim of param `path` is held in;
        None where the layouts agree."""
        return None

    def split_blocks(self, path: str) -> int:
        """The interleaved blocks of param `path`'s model-split dim (see
        `nn.shard.split_part`); 1 is a contiguous split."""
        return 1

    def interchange(self, params: Params) -> Params:
        """`params` in the interchange layout (the JAX package's)."""
        return {k: self.interchange(v) if isinstance(v, dict)
                else self.to_interchange(k, v) for k, v in params.items()}

    # ---- param layout (interchange form = the JAX package's layout) ----
    def from_interchange(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """A param in the interchange layout -> the layout `apply` uses."""
        return value

    def to_interchange(self, key: str, value: torch.Tensor) -> torch.Tensor:
        """Inverse of `from_interchange`."""
        return value

    # ---- config resolution helpers ----
    def act_fn(self, default: str = "identity") -> Callable:
        a = self.activation if self.activation is not None else default
        return act_mod.get(a)

    # ---- serde ----
    def to_json(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if hasattr(v, "to_json") and not isinstance(v, (str, int, float)):
                v = v.to_json()
            d[f.name] = v
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Layer":
        d = dict(d)
        t = d.pop("type")
        if t not in _LAYER_TYPES:
            raise ValueError(f"layer type {t!r} is not ported yet; ported: "
                             f"{sorted(_LAYER_TYPES)}")
        target = _LAYER_TYPES[t]
        if isinstance(d.get("updater"), dict):
            d["updater"] = upd_mod.from_json(d["updater"])
        if isinstance(d.get("dropout"), dict):
            d["dropout"] = drop_mod.from_json(d["dropout"])
        if isinstance(d.get("weight_noise"), dict):
            d["weight_noise"] = wn_mod.from_json(d["weight_noise"])
        field_names = {f.name for f in dataclasses.fields(target)}
        kwargs = {k: v for k, v in d.items() if k in field_names}
        obj = target(**kwargs)
        # tuple-ify list fields that started as tuples
        for f in dataclasses.fields(target):
            v = getattr(obj, f.name)
            if isinstance(v, list) and f.name in ("kernel_size", "stride", "padding", "dilation", "size", "pooling_dimensions"):
                setattr(obj, f.name, tuple(v))
        return obj


def column_parallel_specs(params: Params, model_axis: str,
                          model_size: int):
    """Megatron's column-parallel rule for W[..., n_out] / b[n_out] param
    dicts in the interchange layout (Dense and its kin): the output
    feature axis over the model axis when it divides and is at least
    twice the axis; the bias follows its weight; everything else
    replicates."""
    specs = {k: () for k in params}
    w = params.get("W")
    if model_size > 1 and w is not None and w.dim() >= 2:
        n_out = w.shape[-1]
        if n_out % model_size == 0 and n_out >= 2 * model_size:
            specs["W"] = (None,) * (w.dim() - 1) + (model_axis,)
            b = params.get("b")
            if b is not None and b.shape[-1] == n_out:
                specs["b"] = (model_axis,)
    return specs


_ITERATION = threading.local()


class iteration_scope:
    """Makes a training step's iteration visible to the transforms that
    take probability schedules (dropout p, weight-noise p;
    IDropout.applyDropout(input, iteration, epoch) in the reference), so
    `apply` signatures stay free of the clock. Thread-local, as in the JAX
    package."""

    def __init__(self, iteration: int):
        self.iteration = iteration

    def __enter__(self):
        self._prev = getattr(_ITERATION, "value", None)
        _ITERATION.value = self.iteration
        return self

    def __exit__(self, *exc):
        _ITERATION.value = self._prev
        return False


def current_iteration() -> Optional[int]:
    """The iteration of the enclosing training step, or None outside one."""
    return getattr(_ITERATION, "value", None)


def apply_dropout(x: torch.Tensor, dropout, train: bool, rng) -> torch.Tensor:
    """A layer's `dropout` on its output at train time: a float keeps
    each activation with that probability and scales it by 1/p (inverted
    dropout), an IDropout applies its own transform; the identity at
    inference or without draws. This is the one seam of activation draws:
    in a data-parallel step each is drawn for the global batch and the
    rank keeps its rows (`nn.shard.RowDraws`); weight noise draws alike on
    every rank and does not pass here."""
    if not train or dropout is None or rng is None:
        return x
    obj = drop_mod.resolve(dropout)
    if obj is None:
        return x
    shard = shard_mod.current()
    if shard is not None:
        rng = shard.rows_of(rng)
    return obj.apply(x, rng, iteration=current_iteration())
