"""Ring attention: exact attention over a sequence sharded along the seq
axis of a grid (counterpart of deeplearning4j_tpu/parallel/ring.py).

Each rank holds its time block [b, h, t_loc, d] of q, k and v. K and V
travel once around the ring, one hop per step (`nn.shard.AxisGroup.shift`,
the port's `lax.ppermute`), so after n hops every rank has attended its
queries to the whole sequence. Causal masking uses global block offsets:
at hop s rank r holds the K/V block src = (r - s) mod n, which lies wholly
in its queries' future when src > r.

Two routes, chosen by shape and mask alone, so the CPU takes the route the
card takes:

- no key-padding mask and a head dim in `ops.flash_attention.HEAD_DIMS`:
  the hops run the flash kernels (`_RingFlash`, one autograd Function over
  the whole ring). Forward, each hop launches the forward kernel with its
  lse: the diagonal block (src == r) causal, an earlier block (src < r)
  not, a later block under `causal` not at all (it contributes nothing);
  each hop's (o, lse) is merged into a float32 accumulator by logaddexp.
  Backward, delta = rowsum(dO * O) from the merged output, and per hop the
  dq and dk/dv kernels with the global lse and delta, under the same
  causal rule: no [t_loc, t_loc] score matrix per hop. dq accumulates in
  float32 on its rank; the dK/dV partials accumulate in float32 and travel
  around the ring with their block until they reach its owner. On a
  causal ring rank r launches each kernel r + 1 times, else n times. On
  the CPU the kernels' plain versions run.
- otherwise (a mask, or another head dim): the JAX package's hop, one
  `ops.attention.online_block` per hop (or `online_chunks` over
  `block_size` chunks of a long hop), with K/V rotated by
  `AxisGroup.shift_grad`, whose backward is the inverse rotation, and the
  mask by `shift`.

Entry points:
  sequence_parallel(axis) / active_sequence_axis() -- the context under
      which MultiHeadAttention (and PositionEmbedding) compute on the seq
      axis's shards (ParallelWrapper's seq step);
  ring_attention_sharded -- the per-shard function, on local blocks;
  ring_attention -- over GLOBAL [b, h, t, d] tensors on every rank of a
      grid: each rank takes its time block, runs the ring and gathers the
      output; the gradients of the global inputs are whole on every rank.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.ops import attention as att
from deeplearning4j_tpu_torch.ops import flash_attention as fa

_tls = threading.local()


@contextlib.contextmanager
def sequence_parallel(axis: shard_mod.AxisGroup):
    """While active (on this thread), MultiHeadAttention computes ring
    attention over `axis` (the grid's seq AxisGroup) and PositionEmbedding
    indexes the table at this shard's global offset; activations are the
    shard's [batch, time / axis.size, features]."""
    prev = getattr(_tls, "seq_axis", None)
    _tls.seq_axis = axis
    try:
        yield axis
    finally:
        _tls.seq_axis = prev


def active_sequence_axis() -> Optional[shard_mod.AxisGroup]:
    return getattr(_tls, "seq_axis", None)


def kernel_route(q: torch.Tensor, mask) -> bool:
    """Whether the hops run the flash kernels: no mask and a head dim the
    kernels take."""
    return mask is None and q.shape[-1] in fa.HEAD_DIMS


def _hop_update(acc, q, k_cur, v_cur, m_cur, *, scale, causal, q_off,
                k_off, block_size):
    """One online hop: a single online_block, or online_chunks of
    `block_size` when the hop is longer (the JAX package's _hop_update)."""
    t_loc = k_cur.shape[2]
    if block_size is None or t_loc <= block_size:
        return att.online_block(acc, q, k_cur, v_cur, scale=scale,
                                mask_blk=m_cur, causal=causal,
                                q_offset=q_off, k_offset=k_off)
    return att.online_chunks(acc, q, k_cur, v_cur, scale=scale, mask=m_cur,
                             causal=causal, q_offset=q_off, k_offset=k_off,
                             block_size=block_size)


def _runs(causal: bool, src: int, idx: int) -> bool:
    """Whether the hop holding block `src` on rank `idx` computes."""
    return not (causal and src > idx)


class _RingFlash(torch.autograd.Function):
    """The kernel route over the whole ring (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        n, idx = axis.size, axis.rank
        o_acc = lse_acc = None
        k_cur, v_cur = k, v
        for s in range(n):
            src = (idx - s) % n
            if _runs(causal, src, idx):
                o_s, lse_s = fa.flash_attention(
                    q, k_cur, v_cur, causal and src == idx, scale,
                    return_lse=True)
                if o_acc is None:
                    o_acc, lse_acc = o_s.float(), lse_s
                else:
                    lse_new = torch.logaddexp(lse_acc, lse_s)
                    o_acc = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
                             + o_s.float()
                             * torch.exp(lse_s - lse_new)[..., None])
                    lse_acc = lse_new
            if s != n - 1:
                k_cur, v_cur = axis.shift(k_cur), axis.shift(v_cur)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse_acc.contiguous())
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, scale = ctx.axis, ctx.causal, ctx.scale
        n, idx = axis.size, axis.rank
        do = do.contiguous()
        delta = fa._row_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for s in range(n):
            src = (idx - s) % n
            if _runs(causal, src, idx):
                c = causal and src == idx
                dq += fa.flash_attention_bwd_dq(q, k_cur, v_cur, do, lse,
                                                delta, c, scale).float()
                dk_s, dv_s = fa.flash_attention_bwd_dkv(
                    q, k_cur, v_cur, do, lse, delta, c, scale)
                dk += dk_s.float()
                dv += dv_s.float()
            if s != n - 1:
                k_cur, v_cur = axis.shift(k_cur), axis.shift(v_cur)
            # the partials go on with their block; after the n-th hop
            # they are back with the block's owner
            dk, dv = axis.shift(dk), axis.shift(dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           axis: shard_mod.AxisGroup,
                           mask: Optional[torch.Tensor] = None,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           block_size: Optional[int] = None) -> torch.Tensor:
    """Exact attention where q, k, v [b, h, t_loc, d] (and the key-padding
    `mask` [b, t_loc]) are this rank's time blocks of a sequence sharded
    over `axis`, in q's dtype."""
    d = q.shape[-1]
    scale = fa.default_scale(d) if scale is None else float(scale)
    if kernel_route(q, mask):
        return _RingFlash.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), axis, bool(causal), scale)
    n, idx = axis.size, axis.rank
    t_loc = q.shape[2]
    q_off = idx * t_loc
    acc = att.online_init(q)
    k_cur, v_cur, m_cur = k, v, mask
    for s in range(n):
        src = (idx - s) % n
        acc = _hop_update(acc, q, k_cur, v_cur, m_cur, scale=scale,
                          causal=causal, q_off=q_off, k_off=src * t_loc,
                          block_size=block_size)
        if s != n - 1:
            k_cur = axis.shift_grad(k_cur.contiguous())
            v_cur = axis.shift_grad(v_cur.contiguous())
            if m_cur is not None:
                m_cur = axis.shift(m_cur.contiguous())
    return att.online_finish(acc).to(q.dtype)


class _SeqBlock(torch.autograd.Function):
    """This rank's time block (dim 2) of a global tensor; backward, the
    cotangent blocks of every rank joined, so the global input's gradient
    is whole on each rank."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return shard_mod.split_part(t, dim, 1, axis.size, axis.rank)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g.contiguous(), ctx.dim), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, axis_name: str = "seq",
                   mask: Optional[torch.Tensor] = None,
                   causal: bool = False, scale: Optional[float] = None,
                   block_size: Optional[int] = None) -> torch.Tensor:
    """Ring attention over GLOBAL q, k, v [b, h, t, d] held alike on every
    rank of `mesh` (a `parallel.mesh.Grid`, or an AxisGroup): the time
    axis is sharded over `axis_name`, the ring runs, and the output is
    gathered back (collective: every rank of the axis calls it)."""
    axis = mesh if isinstance(mesh, shard_mod.AxisGroup) else \
        mesh.axis(axis_name)
    if q.shape[2] % axis.size:
        raise ValueError(f"sequence length {q.shape[2]} must divide by the "
                         f"{axis_name} axis ({axis.size})")
    ql, kl, vl = (_SeqBlock.apply(t, axis, 2) for t in (q, k, v))
    ml = None if mask is None else shard_mod.split_part(
        mask, 1, 1, axis.size, axis.rank)
    o = ring_attention_sharded(ql, kl, vl, axis=axis, mask=ml,
                               causal=causal, scale=scale,
                               block_size=block_size)
    return axis.gather(o, 2)
