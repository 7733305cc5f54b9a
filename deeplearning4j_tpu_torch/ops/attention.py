"""Scaled-dot-product attention primitives in plain PyTorch (counterpart of
deeplearning4j_tpu/ops/attention.py).

Three formulations of the softmax(QK^T * scale) V contraction:

  sdpa           the whole [tq, tk] score matrix at once; the path of
                 masked attention (the flash kernel takes no mask).
  blockwise      the online (running max/sum) softmax over key/value chunks
                 of `block_size`: O(t) memory; `attention_impl="blockwise"`.
  online_block   one step of that recurrence, shared by `online_chunks`.

Shapes: q [b, h, tq, d], k/v [b, h, tk, d]. Masks are key-padding masks
[b, tk] (1 = attend); `causal` adds the lower-triangular constraint. Masked
scores are NEG_INF = -1e30, finite, so a fully masked row gives uniform
weights instead of NaN, as in the JAX package. Products go through
`ops.linear.dot`, so the precision policy applies; under bfloat16 the scores
and the softmax stay float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import linear as ops

NEG_INF = -1e30

Acc = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scale_tensor(scale, like: torch.Tensor) -> torch.Tensor:
    """The scale as a 0-d tensor of q's dtype (`jnp.asarray(scale,
    q.dtype)`): q * scale then rounds in q's dtype."""
    return torch.tensor(scale, dtype=like.dtype, device=like.device)


def _scores(q, k, scale):
    # [b, h, tq, d] x [b, h, tk, d] -> [b, h, tq, tk]
    s = ops.dot(q * scale, k.transpose(-1, -2))
    # the softmax and the online recurrence run in float32 even under the
    # bf16 mixed-precision policy
    return s.float() if s.dtype == torch.bfloat16 else s


def _apply_masks(s, *, mask, causal, q_offset, k_offset, tq, tk):
    if mask is not None:
        keep = mask[:, None, None, :].to(torch.bool)
        s = torch.where(keep, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                              device=s.device))
    if causal:
        qi = q_offset + torch.arange(tq, device=s.device)
        ki = k_offset + torch.arange(tk, device=s.device)
        keep = qi[:, None] >= ki[None, :]
        s = s.masked_fill(~keep, NEG_INF)
    return s


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         mask: Optional[torch.Tensor] = None, causal: bool = False,
         scale: Optional[float] = None) -> torch.Tensor:
    """Full-materialization attention: softmax(QK^T * scale [+mask]) V, in
    q's dtype."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = _scores(q, k, _scale_tensor(scale, q))
    s = _apply_masks(s, mask=mask, causal=causal, q_offset=0, k_offset=0,
                     tq=q.shape[2], tk=k.shape[2])
    p = torch.softmax(s, dim=-1)
    # float32 P against a bfloat16 V promotes as lax.dot_general does (the
    # mixed policy casts both to bfloat16 in ops.dot either way)
    return ops.dot(p, v.to(p.dtype)).to(q.dtype)


def online_block(acc: Acc, q: torch.Tensor, k_blk: torch.Tensor,
                 v_blk: torch.Tensor, *, scale,
                 mask_blk: Optional[torch.Tensor] = None,
                 causal: bool = False, q_offset=0, k_offset=0) -> Acc:
    """One step of the online-softmax recurrence. acc = (o [b,h,tq,d]
    unnormalized, l [b,h,tq] row sum, m [b,h,tq] row max); offsets are the
    global positions of the q and k block starts (for causal masking)."""
    o, l, m = acc
    s = _scores(q, k_blk, _scale_tensor(scale, q))
    s = _apply_masks(s, mask=mask_blk, causal=causal, q_offset=q_offset,
                     k_offset=k_offset, tq=q.shape[2], tk=k_blk.shape[2])
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = ops.dot(p, v_blk.to(p.dtype))
    # the accumulators keep the carry dtype (float32 under bf16)
    o_new = o * corr[..., None] + pv.to(o.dtype)
    return o_new, l_new, m_new


def online_init(q: torch.Tensor) -> Acc:
    b, h, tq, d = q.shape
    dt = torch.float32 if q.dtype == torch.bfloat16 else q.dtype
    return (torch.zeros((b, h, tq, d), dtype=dt, device=q.device),
            torch.zeros((b, h, tq), dtype=dt, device=q.device),
            torch.full((b, h, tq), NEG_INF, dtype=dt, device=q.device))


def online_finish(acc: Acc) -> torch.Tensor:
    o, l, _ = acc
    return o / torch.clamp_min(l, 1e-37)[..., None]


def online_chunks(acc: Acc, q, k, v, *, scale, mask=None, causal=False,
                  q_offset=0, k_offset=0, block_size: int = 512) -> Acc:
    """Fold key/value chunks of `block_size` into an online-softmax state.
    A ragged tail is padded with keys masked dead, never widened into one
    bigger block, so peak memory stays O(tq * block_size)."""
    b, h, tk, d = k.shape
    nblk = -(-tk // block_size)
    pad = nblk * block_size - tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        base = (torch.ones((b, tk), dtype=q.dtype, device=q.device)
                if mask is None else mask.to(q.dtype))
        mask = torch.nn.functional.pad(base, (0, pad))
    for i in range(nblk):
        sl = slice(i * block_size, (i + 1) * block_size)
        acc = online_block(acc, q, k[:, :, sl], v[:, :, sl], scale=scale,
                           mask_blk=None if mask is None else mask[:, sl],
                           causal=causal, q_offset=q_offset,
                           k_offset=k_offset + i * block_size)
    return acc


def blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None, causal: bool = False,
              scale: Optional[float] = None,
              block_size: int = 512) -> torch.Tensor:
    """Flash-style O(t) memory attention over key/value chunks (sdpa when
    the keys fit in one block)."""
    d = k.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    if k.shape[2] <= block_size:
        return sdpa(q, k, v, mask=mask, causal=causal, scale=scale)
    acc = online_chunks(online_init(q), q, k, v, scale=scale, mask=mask,
                        causal=causal, block_size=block_size)
    return online_finish(acc).to(q.dtype)
