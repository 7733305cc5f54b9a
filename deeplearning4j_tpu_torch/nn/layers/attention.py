"""Attention and transformer layers (counterpart of
deeplearning4j_tpu/nn/layers/attention.py).

All BTF [batch, time, features]:
  LayerNorm            per-feature normalization over the last axis.
  PositionEmbedding    learned or fixed sinusoidal position encodings.
  MultiHeadAttention   self-attention with a fused qkv projection; causal
                       option; key-padding masks [b, t] (1 = real token).
  TransformerBlock     pre-LN block: x += MHA(LN(x)); x += FFN(LN(x)).

Weights are [n_in, n_out] like Dense, q/k/v fused into one [f, 3f] matmul.

Attention routing in MultiHeadAttention.apply, as in the JAX package: under
a sequence-parallel context (`parallel.ring.sequence_parallel`, the seq
axis of ParallelWrapper's step) ring attention over the axis
(`parallel.ring.ring_attention_sharded`: without a mask and at a kernel
head dim its hops run the flash kernels, else the online hop); outside
one, `attention_impl="blockwise"` takes ops.attention.blockwise; with no
mask, `attention_impl` "auto" or "pallas" and a head dim in the kernel's
set `fa.HEAD_DIMS`, the flash-attention forward (ops/flash_attention.py:
the CUDA kernel on the card, at every length, its plain version on the
CPU); anything else takes ops.attention.sdpa: every masked call, since the
kernel takes no mask, and every other head dim, as the JAX layer sends the
shapes its kernel does not take to sdpa. The route depends on the shape
alone, so the CPU takes the one the card takes. The flash path is
differentiable through the backward kernels. Dropout sits outside the
kernels: MultiHeadAttention's `attn_dropout` on the output projection,
TransformerBlock's `dropout` on the FFN hidden layer, both at train time
only (the block's attention takes no `attn_dropout`, as in the JAX
package).

Under the model axis (Megatron-LM's split): MultiHeadAttention holds its
heads' q, k and v columns of Wqkv and bqkv (three interleaved blocks,
`split_blocks`) and its heads' rows of Wo; it runs the attention on
n_heads / model heads per rank (the flash kernels at local shapes), sums
the ranks' output products (`AxisGroup.reduce`) and adds the whole bo
once. TransformerBlock's FFN holds W1's and b1's columns and W2's rows,
draws its hidden dropout as its columns of the whole mask and sums its
output products before the whole b2. Under both axes (tp x sp) the ring
runs on the rank's local heads.

Every layer here declares `sp_safe` (the JAX package's values): each
computes per timestep or is ring-aware, so the seq axis may shard its
time axis; PositionEmbedding then indexes its table at the shard's global
offset and refuses a global length past `max_len`.
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
    register_layer,
)
from deeplearning4j_tpu_torch.ops import attention as att
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import linear as ops


def _ring():
    # lazy: parallel.* imports models, which import nn.layers (this package)
    from deeplearning4j_tpu_torch.parallel import ring
    return ring


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * gamma + beta over the last axis, with
    the population variance (jnp.var; torch.var's default is unbiased)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def _ln_params(f: int):
    return {"gamma": torch.ones(f), "beta": torch.zeros(f)}


@register_layer
@dataclass
class LayerNorm(Layer):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta over the last axis."""

    eps: float = 1e-5

    sp_safe = True  # normalizes the feature axis only

    def output_type(self, input_type):
        return input_type

    def init_params(self, gen, input_type):
        if isinstance(input_type, it.Recurrent):
            return _ln_params(input_type.size)
        return _ln_params(input_type.arity())

    def regularizable(self, params):
        return {}

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return layer_norm(x, params["gamma"], params["beta"], self.eps), state


@register_layer
@dataclass
class PositionEmbedding(Layer):
    """Adds position encodings to [b, t, f] activations.

    mode="learned": trainable [max_len, f] table (GPT-style).
    mode="sincos":  fixed sinusoidal encodings (Vaswani et al.), no params.
    Under sequence parallelism the time axis is sharded; the table is
    indexed at the shard's global offset.
    """

    max_len: int = 512
    mode: str = "learned"  # learned | sincos

    sp_safe = True  # indexes the table at global offsets under seq sharding

    def output_type(self, input_type):
        return input_type

    def init_params(self, gen, input_type):
        if self.mode != "learned":
            return {}
        f = input_type.size
        scheme = self.weight_init or "normal"
        w = init_mod.init(scheme, gen, (self.max_len, f), fan_in=f, fan_out=f)
        return {"pos": w * 0.02 if scheme == "normal" else w}

    def has_params(self):
        return self.mode == "learned"

    def regularizable(self, params):
        return {}

    @staticmethod
    def sincos(t: int, f: int, dtype, device=None) -> torch.Tensor:
        """[t, f] sinusoidal table in `dtype` (the last column zero when f
        is odd)."""
        pos = torch.arange(t, dtype=dtype, device=device)[:, None]
        i = torch.arange(f // 2, dtype=dtype, device=device)[None, :]
        angle = pos / torch.pow(10000.0, 2 * i / f)
        emb = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
        if emb.shape[-1] < f:
            emb = torch.nn.functional.pad(emb, (0, f - emb.shape[-1]))
        return emb

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        b, t, f = x.shape
        axis = _ring().active_sequence_axis()
        off = 0 if axis is None else axis.rank * t
        t_global = t if axis is None else t * axis.size
        if self.mode == "learned":
            if t_global > self.max_len:
                # slicing would silently give a shorter table; under
                # sequence parallelism the GLOBAL length must fit
                raise ValueError(
                    f"sequence length {t_global} exceeds PositionEmbedding "
                    f"max_len={self.max_len}")
            pe = params["pos"][off:off + t]
        else:
            if axis is not None and t_global > self.max_len:
                raise ValueError(
                    f"sequence length {t_global} exceeds PositionEmbedding "
                    f"max_len={self.max_len} (sincos under seq sharding)")
            full = self.sincos(t if axis is None else self.max_len, f,
                               x.dtype, x.device)
            pe = full[off:off + t]
        return x + pe.to(x.dtype)[None], state


@register_layer
@dataclass
class MultiHeadAttention(Layer):
    """Self-attention over [b, t, f]: fused qkv projection, attention (see
    the module docstring for the routing), output projection.

    n_out defaults to n_in. A key-padding `mask` [b, t] (1 = real token)
    masks keys and zeroes padded query positions; `causal` adds the
    autoregressive constraint.
    """

    n_heads: int = 8
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    causal: bool = False
    attention_impl: str = "auto"
    block_size: int = 512
    attn_dropout: Optional[float] = None  # retain prob, DL4J convention

    computes_model_shards = True
    sp_safe = True  # dispatches to ring attention under sequence_parallel

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        """Wqkv and bqkv column-split by heads, Wo row-split, bo whole
        (added after the sum), when the heads and the width divide;
        otherwise everything replicates."""
        specs = {k: () for k in params}
        f = params["Wqkv"].shape[0]
        if (model_size > 1 and self.n_heads % model_size == 0
                and f % model_size == 0):
            specs["Wqkv"] = (None, model_axis)
            specs["bqkv"] = (model_axis,)
            specs["Wo"] = (model_axis, None)
        return specs

    def split_blocks(self, path):
        return 3 if path in ("Wqkv", "bqkv") else 1

    def output_type(self, input_type):
        f = self.n_out or input_type.size
        return it.Recurrent(f, getattr(input_type, "timesteps", -1))

    def init_params(self, gen, input_type):
        f = self.n_in or input_type.size
        out = self.n_out or f
        if f % self.n_heads:
            raise ValueError(f"n_heads={self.n_heads} must divide d_model={f}")
        wi = self.weight_init or "xavier"
        wqkv = init_mod.init(wi, gen, (f, 3 * f), fan_in=f, fan_out=3 * f)
        wo = init_mod.init(wi, gen, (f, out), fan_in=f, fan_out=out)
        return {"Wqkv": wqkv, "bqkv": torch.zeros(3 * f),
                "Wo": wo, "bo": torch.zeros(out)}

    def regularizable(self, params):
        return {k: v for k, v in params.items() if k.startswith("W")}

    def attend(self, q, k, v, mask):
        """[b, h, t, d] heads -> [b, h, t, d] attention output."""
        axis = _ring().active_sequence_axis()
        if axis is not None:
            return _ring().ring_attention_sharded(
                q, k, v, axis=axis, mask=mask, causal=self.causal,
                block_size=self.block_size)
        if self.attention_impl == "blockwise":
            return att.blockwise(q, k, v, mask=mask, causal=self.causal,
                                 block_size=self.block_size)
        if (mask is None and self.attention_impl in ("auto", "pallas")
                and q.shape[-1] in fa.HEAD_DIMS):
            # the kernel takes [b, h, t, d] contiguous: copy the head-split
            # views here, once each, rather than inside the wrapper
            return fa.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), self.causal)
        return att.sdpa(q, k, v, mask=mask, causal=self.causal)

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        b, t, f = x.shape
        d = f // self.n_heads
        fl = params["Wqkv"].shape[1] // 3  # this rank's heads' width
        tp = shard_mod.model_split() if fl != f else None
        h = fl // d
        if tp is not None:
            x = tp.copy(x)
        qkv = ops.bias_add(ops.dot(x, params["Wqkv"]), params["bqkv"])

        def heads(a):  # [b, t, fl] -> [b, h, t, d]
            return a.reshape(b, t, h, d).transpose(1, 2)

        q, k, v = (heads(a) for a in qkv.split(fl, dim=-1))
        o = self.attend(q, k, v, mask)
        o = o.transpose(1, 2).reshape(b, t, fl)
        z = ops.dot(o, params["Wo"])
        if tp is not None:
            z = tp.reduce(z)
        y = ops.bias_add(z, params["bo"])
        y = apply_dropout(y, self.attn_dropout, train, rng)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state


@register_layer
@dataclass
class TransformerBlock(Layer):
    """Pre-LN transformer block:
        x = x + MHA(LN(x));  x = x + W2 . act(W1 . LN(x)).
    One Layer, so networks stay flat lists; params nest the sublayers':
    {"ln1": {gamma, beta}, "attn": {Wqkv, bqkv, Wo, bo}, "ln2": {...},
    "W1", "b1", "W2", "b2"}."""

    n_heads: int = 8
    n_in: Optional[int] = None
    ffn_mult: int = 4
    causal: bool = False
    attention_impl: str = "auto"
    eps: float = 1e-5

    computes_model_shards = True
    sp_safe = True  # MHA rings, LN/FFN are per-timestep

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        """Attention by MultiHeadAttention's rule; the FFN Megatron's way:
        W1 and b1 column-split, W2 row-split, b2 whole."""
        f, hid = params["W1"].shape
        specs = {
            "ln1": {k: () for k in params["ln1"]},
            "attn": self._sub(f).tensor_partition_specs(
                params["attn"], model_axis, model_size),
            "ln2": {k: () for k in params["ln2"]},
            "W1": (), "b1": (), "W2": (), "b2": (),
        }
        if model_size > 1 and hid % model_size == 0:
            specs["W1"] = (None, model_axis)
            specs["b1"] = (model_axis,)
            specs["W2"] = (model_axis, None)
        return specs

    def split_blocks(self, path):
        return 3 if path in ("attn/Wqkv", "attn/bqkv") else 1

    def __post_init__(self):
        if self.activation is None:
            self.activation = "gelu"

    def output_type(self, input_type):
        return input_type

    def _sub(self, f):
        return MultiHeadAttention(n_heads=self.n_heads, n_in=f,
                                  causal=self.causal,
                                  attention_impl=self.attention_impl,
                                  weight_init=self.weight_init)

    def init_params(self, gen, input_type):
        f = self.n_in or input_type.size
        hid = self.ffn_mult * f
        wi = self.weight_init or "xavier"
        attn = self._sub(f).init_params(gen, input_type)
        return {
            "ln1": _ln_params(f),
            "attn": attn,
            "ln2": _ln_params(f),
            "W1": init_mod.init(wi, gen, (f, hid), fan_in=f, fan_out=hid),
            "b1": torch.zeros(hid),
            "W2": init_mod.init(wi, gen, (hid, f), fan_in=hid, fan_out=f),
            "b2": torch.zeros(f),
        }

    def regularizable(self, params):
        out = {"W1": params["W1"], "W2": params["W2"]}
        out.update({"attn/" + k: v for k, v in params["attn"].items()
                    if k.startswith("W")})
        return out

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        f = x.shape[-1]
        ln1, ln2 = params["ln1"], params["ln2"]
        a, _ = self._sub(f).apply(
            params["attn"], layer_norm(x, ln1["gamma"], ln1["beta"], self.eps),
            state={}, train=train, mask=mask, rng=rng)
        x = x + a
        hn = layer_norm(x, ln2["gamma"], ln2["beta"], self.eps)
        whole = self.ffn_mult * f
        tp = (shard_mod.model_split() if params["W1"].shape[1] != whole
              else None)
        if tp is not None:
            hn = tp.copy(hn)
            if rng is not None:
                rng = tp.columns_of(rng, whole)
        hid = self.act_fn("gelu")(ops.bias_add(ops.dot(hn, params["W1"]),
                                               params["b1"]))
        hid = apply_dropout(hid, self.dropout, train, rng)
        z = ops.dot(hid, params["W2"])
        if tp is not None:
            z = tp.reduce(z)
        y = x + ops.bias_add(z, params["b2"])
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state
