"""Recurrent layers, the part the char-RNN path runs: BaseRecurrent, LSTM
and GravesLSTM (counterpart of deeplearning4j_tpu/nn/layers/recurrent.py;
GravesBidirectionalLSTM, SimpleRnn and LastTimeStep come with a later
slice).

Layout BTF [batch, time, features]; gate order (i, f, g, o); params W
[f, 4n], R [n, 4n], b [4n] and, for GravesLSTM, the diagonal peepholes pi,
pf, po [n], under the JAX package's names. Masked steps carry state through
unchanged and output zeros. Stateful inference (`rnn_time_step`) and tBPTT
thread an explicit (h, c) carry through `scan`.

Cell math (peephole terms only for GravesLSTM):
    i = gate_act(x Wi + h Ri [+ pi*c_prev] + bi)
    f = gate_act(x Wf + h Rf [+ pf*c_prev] + bf)
    g = act(x Wg + h Rg + bg)
    c = f*c_prev + i*g
    o = gate_act(x Wo + h Ro [+ po*c] + bo)
    h = o * act(c)

Routing in `_lstm_scan`, the JAX package's: the input projection for all
timesteps is one matmul (ops/linear.py); a sigmoid/tanh cell in float32 or
bfloat16 with n <= `lstm_ops.MAX_N` (the kernels' cap) then goes to a fused
scan (ops/lstm.py: the CUDA kernels on the card at every b and t, their
plain versions on the CPU), whose backward is a kernel too. Inside `chunked_lstm_auto_regime` (float32, t >= 1024,
b <= 16, n >= 128), where the JAX package runs its time-chunked kernels by
default, the chunked family runs (`lstm_scan_chunked`: checkpoints every
`lstm_ops.CHUNK` steps, backward `lstm_scan_chunked_bwd`); everywhere else
`lstm_scan` (backward `lstm_scan_bwd`). Both give the same results. Any
other cell (another gate activation, float64, n past `MAX_N`) takes a
per-step loop with the JAX scan's own numerics, differentiated by
autograd, as the JAX layer sends the shapes its kernels do not take to
`lax.scan`. The route depends on shape and dtype alone, so the CPU takes
the one the card takes. The JAX package's
helper modes (`DL4J_TPU_PALLAS_LSTM`) and VMEM-sized block and chunk picks
have no counterpart here.
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
               mask=None, prefix: str = ""):
    """Shared LSTM scan. params keys (optionally prefixed): W [f, 4n],
    R [n, 4n], b [4n], and pi/pf/po [n] if peephole."""
    R = params[prefix + "R"]
    n = R.shape[0]
    # hoisted input projection: one matmul over all timesteps
    zx = ops.bias_add(ops.dot(x, params[prefix + "W"]),
                      params[prefix + "b"])  # [b, t, 4n]
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

    m_t = None if mask is None else mask.to(x.dtype)
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
