"""Recurrent layers: BaseRecurrent, LSTM, GravesLSTM,
GravesBidirectionalLSTM, SimpleRnn and the LastTimeStep wrapper
(counterpart of deeplearning4j_tpu/nn/layers/recurrent.py).

Layout BTF [batch, time, features]; gate order (i, f, g, o); params W
[f, 4n], R [n, 4n], b [4n] and, for GravesLSTM, the diagonal peepholes pi,
pf, po [n], under the JAX package's names. Masked steps carry state through
unchanged and output zeros. Stateful inference (`rnn_time_step`) and tBPTT
thread an explicit (h, c) carry through `scan` (GravesBidirectionalLSTM:
((h, c) forward, (h, c) backward); SimpleRnn: h alone).

Cell math (peephole terms only for GravesLSTM):
    i = gate_act(x Wi + h Ri [+ pi*c_prev] + bi)
    f = gate_act(x Wf + h Rf [+ pf*c_prev] + bf)
    g = act(x Wg + h Rg + bg)
    c = f*c_prev + i*g
    o = gate_act(x Wo + h Ro [+ po*c] + bo)
    h = o * act(c)

Under the model axis the LSTMs split their gate axis (W, R and b, and the
peepholes; `_lstm_partition_specs`) and SimpleRnn its units, as the JAX
package places them, and gather them whole on use: the recurrence needs
every unit of h at every step, and the scan kernels keep h on chip.

Routing in `_lstm_scan` / `_lstm_recurrence`, the JAX package's: the
input projection for all timesteps is one matmul (ops/linear.py); a
sigmoid/tanh cell in float32 or bfloat16 with n <= `lstm_ops.MAX_N` (the
kernels' cap) then goes to a fused scan (ops/lstm.py: the CUDA kernels on
the card at every b and t, their plain versions on the CPU), whose
backward is a kernel too. Inside `chunked_lstm_auto_regime` (float32, t >=
1024, b <= 16, n >= 128), where the JAX package runs its time-chunked
kernels by default, the chunked family runs (`lstm_scan_chunked`:
checkpoints every `lstm_ops.CHUNK` steps, backward
`lstm_scan_chunked_bwd`); everywhere else `lstm_scan` (backward
`lstm_scan_bwd`). Both give the same results. Any other cell (another
gate activation, float64, n past `MAX_N`) takes a per-step loop with the
JAX scan's own numerics, differentiated by autograd, as the JAX layer
sends the shapes its kernels do not take to `lax.scan`. The route depends
on shape and dtype alone, so the CPU takes the one the card takes. A
reverse scan (the backward half of GravesBidirectionalLSTM) is the same
recurrence on the time-flipped zx, the mask flipped with it and hs
flipped back, on either route, as the JAX package's kernel route does;
with a right-padded mask the flipped rows lead with their dead steps. The
JAX package's helper modes (`DL4J_TPU_PALLAS_LSTM`) and VMEM-sized block
and chunk picks have no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import initializers as init_mod
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    apply_dropout,
    column_parallel_specs,
    register_layer,
)
from deeplearning4j_tpu_torch.ops import linear as ops
from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

Carry = Tuple[torch.Tensor, torch.Tensor]


def chunked_lstm_auto_regime(batch: int, timesteps: int, n_hidden: int,
                             dtype) -> bool:
    """The JAX package's regime for its time-chunked LSTM kernels (its
    nn/layers/recurrent.py `chunked_lstm_auto_regime`, admitted there by
    default): float32, t >= 1024, b <= 16, n >= 128. Here it picks the
    chunked family for inference and training alike."""
    return (dtype == torch.float32 and timesteps >= 1024
            and batch <= 16 and n_hidden >= 128)


class BaseRecurrent(Layer):
    """Adds the carry protocol used by rnn_time_step and tBPTT."""

    # False for bidirectional layers: the backward scan needs the sequence
    # end, so a streaming state carry is ill-defined
    streamable = True

    def init_carry(self, batch: int, device=None) -> Carry:
        raise NotImplementedError

    def scan(self, params, x, carry, *, mask=None, train=False, rng=None):
        """x [b, t, f] -> (y [b, t, n], carry_out); the layer's dropout on
        y at train time."""
        raise NotImplementedError


def _lstm_scan(params, x, carry, gate_fn, act_fn, peephole: bool,
               mask=None, reverse: bool = False, prefix: str = ""):
    """Shared LSTM scan. params keys (optionally prefixed for the
    bidirectional layer): W [f, 4n], R [n, 4n], b [4n], and pi/pf/po [n]
    if peephole. With `reverse` the scan runs from the last step to the
    first."""
    # hoisted input projection: one matmul over all timesteps
    zx = ops.bias_add(ops.dot(x, params[prefix + "W"]),
                      params[prefix + "b"])  # [b, t, 4n]
    if reverse:
        zx = torch.flip(zx, dims=(1,))
        mask = None if mask is None else torch.flip(mask, dims=(1,))
    hs, carry_out = _lstm_recurrence(params, zx, carry, gate_fn, act_fn,
                                     peephole, mask, prefix)
    if reverse:
        hs = torch.flip(hs, dims=(1,))
    return hs, carry_out


def _lstm_recurrence(params, zx, carry, gate_fn, act_fn, peephole: bool,
                     mask, prefix: str):
    """The recurrence over zx [b, t, 4n] from step 0: a fused scan where
    the kernels take the cell, else the per-step loop."""
    R = params[prefix + "R"]
    n = R.shape[0]
    h0, c0 = (c.to(zx.dtype) for c in carry)
    if (zx.dtype in (torch.float32, torch.bfloat16) and n <= lstm_ops.MAX_N
            and gate_fn is act_mod.get("sigmoid")
            and act_fn is act_mod.get("tanh")):
        # R joins the compute dtype: under the mixed policy params are f32
        # while activations are bf16
        Rk = R.to(zx.dtype)
        chunked = chunked_lstm_auto_regime(zx.shape[0], zx.shape[1], n,
                                           zx.dtype)
        if peephole:
            p = torch.stack([params[prefix + "pi"], params[prefix + "pf"],
                             params[prefix + "po"]]).to(zx.dtype)
            scan = (lstm_ops.lstm_scan_chunked_peephole if chunked
                    else lstm_ops.lstm_scan_peephole)
            hs, hT, cT = scan(zx, Rk, p, h0, c0, mask)
        else:
            scan = (lstm_ops.lstm_scan_chunked if chunked
                    else lstm_ops.lstm_scan)
            hs, hT, cT = scan(zx, Rk, h0, c0, mask)
        return hs, (hT, cT)

    m_t = None if mask is None else mask.to(zx.dtype)
    h_prev, c_prev = h0, c0
    ys = []
    for s in range(zx.shape[1]):
        z = zx[:, s] + ops.dot(h_prev, R)
        zi, zf, zg, zo = z.split(n, dim=-1)
        if peephole:
            zi = zi + params[prefix + "pi"].to(c_prev.dtype) * c_prev
            zf = zf + params[prefix + "pf"].to(c_prev.dtype) * c_prev
        i = gate_fn(zi)
        f = gate_fn(zf)
        g = act_fn(zg)
        c = f * c_prev + i * g
        if peephole:
            zo = zo + params[prefix + "po"].to(c.dtype) * c
        h = gate_fn(zo) * act_fn(c)
        if m_t is not None:
            live = m_t[:, s, None] > 0
            h = torch.where(live, h, torch.zeros_like(h))
            c = torch.where(live, c, c_prev)
            h_carry = torch.where(live, h, h_prev)
        else:
            h_carry = h
        ys.append(h)
        h_prev, c_prev = h_carry, c
    y = (torch.stack(ys, dim=1) if ys
         else zx.new_zeros((zx.shape[0], 0, n)))
    return y, (h_prev, c_prev)


def _lstm_partition_specs(params, model_axis, model_size, n_out,
                          prefixes=("",)):
    """The gate-block column split of LSTM params: W [f, 4n], R [n, 4n]
    and b [4n] over their gate axis, the peepholes [n] with them, when
    model_size divides n_out and n_out is at least twice it."""
    specs = {k: () for k in params}
    if model_size > 1 and n_out % model_size == 0 and n_out >= 2 * model_size:
        for pre in prefixes:
            for k in ("W", "R"):
                if pre + k in params:
                    specs[pre + k] = (None, model_axis)
            for k in ("b", "pi", "pf", "po"):
                if pre + k in params:
                    specs[pre + k] = (model_axis,)
    return specs


def _init_lstm_params(gen, n_in, n_out, weight_init, dist, forget_bias,
                      peephole: bool, prefix: str = ""):
    wi = weight_init or "xavier"
    p = {
        prefix + "W": init_mod.init(wi, gen, (n_in, 4 * n_out), fan_in=n_in,
                                    fan_out=4 * n_out, distribution=dist),
        prefix + "R": init_mod.init(wi, gen, (n_out, 4 * n_out),
                                    fan_in=n_out, fan_out=4 * n_out,
                                    distribution=dist),
    }
    b = torch.zeros(4 * n_out)
    # forget-gate bias init (DL4J forgetGateBiasInit, default 1.0)
    b[n_out:2 * n_out] = forget_bias
    p[prefix + "b"] = b
    if peephole:
        for k in ("pi", "pf", "po"):
            p[prefix + k] = torch.zeros(n_out)
    return p


@register_layer
@dataclass
class LSTM(BaseRecurrent):
    """No-peephole LSTM (nn/conf/layers/LSTM.java)."""

    n_in: Optional[int] = None
    n_out: int = 0
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    _peephole = False

    def output_type(self, input_type):
        t = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(self.n_out, t)

    def init_params(self, gen, input_type):
        n_in = self.n_in or input_type.size
        return _init_lstm_params(gen, n_in, self.n_out, self.weight_init,
                                 self.dist, self.forget_gate_bias_init,
                                 self._peephole)

    def init_carry(self, batch, device=None):
        # two buffers: the carry is (h, c), never one tensor twice
        return (torch.zeros((batch, self.n_out), device=device),
                torch.zeros((batch, self.n_out), device=device))

    def regularizable(self, params):
        return {k: v for k, v in params.items() if k in ("W", "R")}

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        return _lstm_partition_specs(params, model_axis, model_size,
                                     self.n_out)

    def scan(self, params, x, carry, *, mask=None, train=False, rng=None):
        y, carry_out = _lstm_scan(params, x, carry,
                                  act_mod.get(self.gate_activation),
                                  self.act_fn("tanh"), self._peephole,
                                  mask=mask)
        return apply_dropout(y, self.dropout, train, rng), carry_out

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        y, _ = self.scan(params, x, self.init_carry(x.shape[0], x.device),
                         mask=mask, train=train, rng=rng)
        return y, state


@register_layer
@dataclass
class GravesLSTM(LSTM):
    """Peephole LSTM (Graves 2013 formulation;
    nn/conf/layers/GravesLSTM.java)."""

    _peephole = True


@register_layer
@dataclass
class GravesBidirectionalLSTM(BaseRecurrent):
    """Two independent peephole LSTMs, one forward and one backward over
    time, under the params f_* and b_*; their outputs are summed
    (GravesBidirectionalLSTM.java:224-225), so nOut stays nOut. The layer's
    dropout applies to the sum."""

    streamable = False

    n_in: Optional[int] = None
    n_out: int = 0
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def output_type(self, input_type):
        t = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(self.n_out, t)

    def init_params(self, gen, input_type):
        n_in = self.n_in or input_type.size
        p = _init_lstm_params(gen, n_in, self.n_out, self.weight_init,
                              self.dist, self.forget_gate_bias_init, True,
                              prefix="f_")
        p.update(_init_lstm_params(gen, n_in, self.n_out, self.weight_init,
                                   self.dist, self.forget_gate_bias_init,
                                   True, prefix="b_"))
        return p

    def regularizable(self, params):
        return {k: v for k, v in params.items()
                if k.endswith("W") or k.endswith("R")}

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        return _lstm_partition_specs(params, model_axis, model_size,
                                     self.n_out, prefixes=("f_", "b_"))

    def init_carry(self, batch, device=None):
        def z():
            return torch.zeros((batch, self.n_out), device=device)

        return ((z(), z()), (z(), z()))

    def scan(self, params, x, carry, *, mask=None, train=False, rng=None):
        gate = act_mod.get(self.gate_activation)
        act = self.act_fn("tanh")
        yf, cf = _lstm_scan(params, x, carry[0], gate, act, True, mask=mask,
                            prefix="f_")
        # the backward half cannot carry across tBPTT windows: a reverse
        # scan starts at the window's end, and the incoming carry was made
        # at the earlier window's start. So it starts from zeros in every
        # window; only the forward half carries (the JAX package's rule)
        fresh = tuple(torch.zeros_like(c) for c in carry[1])
        yb, cb = _lstm_scan(params, x, fresh, gate, act, True, mask=mask,
                            reverse=True, prefix="b_")
        return apply_dropout(yf + yb, self.dropout, train, rng), (cf, cb)

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        y, _ = self.scan(params, x, self.init_carry(x.shape[0], x.device),
                         mask=mask, train=train, rng=rng)
        return y, state


@register_layer
@dataclass
class SimpleRnn(BaseRecurrent):
    """Vanilla RNN: h_t = act(x_t W + h_{t-1} R + b); masked steps output
    zeros and carry h through. The JAX package runs it with `lax.scan`
    and no kernel, so here it is a per-step loop differentiated by
    autograd. The carry is h alone."""

    n_in: Optional[int] = None
    n_out: int = 0

    def output_type(self, input_type):
        t = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(self.n_out, t)

    def init_params(self, gen, input_type):
        n_in = self.n_in or input_type.size
        wi = self.weight_init or "xavier"
        return {
            "W": init_mod.init(wi, gen, (n_in, self.n_out),
                               distribution=self.dist),
            "R": init_mod.init(wi, gen, (self.n_out, self.n_out),
                               distribution=self.dist),
            "b": torch.zeros(self.n_out),
        }

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        """Dense's column rule on W; R's output axis follows a split W."""
        specs = column_parallel_specs(params, model_axis, model_size)
        if specs.get("W"):
            specs["R"] = (None, model_axis)
        return specs

    def regularizable(self, params):
        return {k: v for k, v in params.items() if k in ("W", "R")}

    def init_carry(self, batch, device=None):
        return torch.zeros((batch, self.n_out), device=device)

    def scan(self, params, x, carry, *, mask=None, train=False, rng=None):
        act = self.act_fn("tanh")
        zx = ops.bias_add(ops.dot(x, params["W"]), params["b"])
        h_prev = carry.to(zx.dtype)
        live = None if mask is None else mask.to(x.dtype) > 0
        ys = []
        for s in range(zx.shape[1]):
            h = act(zx[:, s] + ops.dot(h_prev, params["R"]))
            if live is not None:
                h = torch.where(live[:, s, None], h, torch.zeros_like(h))
                h_prev = torch.where(live[:, s, None], h, h_prev)
            else:
                h_prev = h
            ys.append(h)
        y = (torch.stack(ys, dim=1) if ys
             else zx.new_zeros((zx.shape[0], 0, self.n_out)))
        return apply_dropout(y, self.dropout, train, rng), h_prev

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        y, _ = self.scan(params, x, self.init_carry(x.shape[0], x.device),
                         mask=mask, train=train, rng=rng)
        return y, state


@register_layer
@dataclass
class LastTimeStep(Layer):
    """Wraps a layer: its [b, t, f] output -> the last live step [b, f]
    (LastTimeStepVertex.java as a layer). With a mask the step taken is
    clip(sum(mask) - 1, 0, t - 1), which assumes right-padded masks and
    gives step 0 to a row with no live step, as the JAX package does;
    without one the last step."""

    underlying: Optional[dict] = None  # the wrapped layer's JSON

    def __post_init__(self):
        if isinstance(self.underlying, Layer):
            self._inner = self.underlying
        elif isinstance(self.underlying, dict):
            self._inner = Layer.from_json(self.underlying)
        else:
            self._inner = None

    def output_type(self, input_type):
        ot = self._inner.output_type(input_type) if self._inner else input_type
        return it.FeedForward(ot.size if isinstance(ot, it.Recurrent)
                              else ot.arity())

    def init_params(self, gen, input_type):
        return self._inner.init_params(gen, input_type) if self._inner else {}

    def has_params(self):
        return self._inner.has_params() if self._inner else False

    def tensor_partition_specs(self, params, model_axis="model", model_size=1):
        if self._inner is not None:
            return self._inner.tensor_partition_specs(params, model_axis,
                                                      model_size)
        return super().tensor_partition_specs(params, model_axis, model_size)

    def propagate_mask(self, mask, input_type):
        return None

    def to_json(self):
        d = super().to_json()
        if self._inner is not None:
            d["underlying"] = self._inner.to_json()
        return d

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        if self._inner is not None:
            x, state = self._inner.apply(params, x, state=state, train=train,
                                         mask=mask, rng=rng)
        return last_step(x, mask), state


def last_step(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x [b, t, f] -> [b, f]: each row's step clip(sum(mask) - 1, 0, t - 1),
    or the last step without a mask (LastTimeStep, LastTimeStepVertex)."""
    if mask is None:
        return x[:, -1]
    idx = (mask.to(torch.int32).sum(dim=1) - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]
