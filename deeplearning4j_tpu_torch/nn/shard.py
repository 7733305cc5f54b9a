"""The data-parallel shard of a training step: which rows of the global
batch this process holds, and the process group that joins it to the
ranks holding the others (the state `parallel.ParallelWrapper` gives the
step; the JAX package gets the same from GSPMD over its mesh).

A rank-per-process step equals the single-process step on the global batch
only where every quantity that spans the batch is taken over the global
batch. The layers that take one ask `current()`, which is the wrapper's
shard while a training step's loss and gradients are computed
(`models._training.value_and_grad`) and None everywhere else, so nothing
changes without the wrapper, nor in a listener's `score` inside a fit:

- a loss's masked mean divides by the global active count
  (`nn.losses.reduce_score`): each rank's loss is its share of the global
  mean, and the shares sum to it (Yolo2Output's mean over the images
  too);
- CenterLossOutput's center term is each rank's share of the global
  mean, and its centers move by the global batch's per-class sums and
  counts (`all_sum`), so every rank's centers stay the same;
- BatchNorm's batch statistics are the global batch's, through a
  differentiable all-reduce (`all_sum_grad`), so their gradients reach
  every rank's rows;
- an activation's dropout mask is drawn for the global batch and the
  rank keeps its rows (`rows_of`), so every rank's mask is its rows of the
  single-process mask; weight noise is drawn alike on every rank;
- the l1/l2 penalty counts on rank 0 only (`counts_penalty`);
- the gradients are summed across ranks in flat buckets, the score with
  them (`reduce`), so the updater sees the global batch's gradient.

On a grid of several axes (`parallel.mesh.build_mesh`) the shard's group
is the data axis's sub-group: the model and fsdp ranks of one data
coordinate hold the same rows, so the row blocks, the global counts and
statistics and the gradient reduce span the data axis only, as the JAX
package splits its batch over 'data' alone.

The model axis (tensor parallelism) and the fsdp axis (parameters sharded
at rest) run through `AxisGroup`, one sub-group of the grid, and four
autograd Functions around its collectives (Megatron-LM's):

- `AxisGroup.copy` (*f*): the identity forward, an all-reduce of the
  cotangent backward; it enters a layer that computes a slice of its
  output from a replicated input, whose gradient each rank holds a part
  of;
- `AxisGroup.reduce` (*g*): an all-reduce forward, the identity backward;
  it sums the partial outputs of a row-split product;
- `AxisGroup.gather`: an all-gather along a dim (a column-split
  activation, or a sharded param gathered on use), whose backward keeps
  this rank's slice of the cotangent. The ranks of the group compute on
  the same rows, so the cotangent of the gathered tensor is the same on
  each and nothing is summed: the data axis's reduce sums it later;
- `AxisGroup.slice`: this rank's slice of a whole tensor (no collective).

A dim may be split in `blocks` interleaved blocks: rank r holds the r-th
part of each block (MultiHeadAttention's Wqkv keeps its heads' q, k and v
columns). A layer that computes on its model shards runs inside
`splitting(group)`, and `model_split()` gives it the group there.
The collectives are those that gloo and NCCL both take on CUDA tensors
(all_reduce, all_gather, broadcast), so one code path serves both.

The seq and pipe axes move tensors point to point (`lax.ppermute` in the
JAX package):

- `AxisGroup.shift(t, offset)`: rank j sends `t` to rank (j + offset) mod
  n and returns what rank (j - offset) mod n sent (ring attention's K/V
  hop);
- `AxisGroup.shift_grad`: its autograd form, whose backward shifts the
  cotangent back by -offset (the inverse permutation);
- `AxisGroup.send` / `recv`: the non-wrapping stage-to-stage hop, one
  message to or from one rank of the group (a pipeline stage's boundary
  activation to the next stage, its cotangent back; heterogeneous shapes
  included, the receiver giving the shape).

gloo's send and recv take a host pointer (they hand the tensor's raw
buffer to the TCP transport, which reads it on the host), so on gloo a
CUDA tensor is staged explicitly through a host buffer on each side: the
tensor leaves and lands on the card, the bytes cross on the host. NCCL
sends CUDA tensors directly. A ring shift goes out as one batch of a send
and a receive per rank (`batch_isend_irecv`, which NCCL needs for a
cycle); `stats` counts each hop and its bytes.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

# The gradients go to the all-reduce in flat buffers of about this many
# bytes (DistributedDataParallel's default bucket size).
BUCKET_BYTES = 25 * 2 ** 20


@dataclass
class ReduceStats:
    """What the gradient reduce moved: bytes all-reduced, collectives
    launched and reduced steps. With `events` a list, each bucket's pack
    and all-reduce is bracketed by CUDA events (a pair per bucket) or, on
    the CPU, by the host clock (seconds), for `seconds()`."""

    bytes: int = 0
    collectives: int = 0
    steps: int = 0
    events: Optional[list] = None

    def seconds(self) -> float:
        """Time inside the timed buckets' pack and all-reduce (waits for
        the device)."""
        total = 0.0
        for a, b in self.events or ():
            if isinstance(a, torch.cuda.Event):
                b.synchronize()
                total += a.elapsed_time(b) / 1e3
            else:
                total += b - a
        return total


class _AllSum(torch.autograd.Function):
    """The sum of a tensor over the group's ranks, with its gradient: the
    backward all-reduces the cotangent, since every rank's loss depends on
    every rank's term."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _Copy(torch.autograd.Function):
    """Megatron's f: the identity forward, the cotangent summed over the
    group backward."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_sum(g), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: the sum over the group forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, t, axis):
        return axis.all_sum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Shift(torch.autograd.Function):
    """`AxisGroup.shift` by `offset` forward; backward, the cotangent
    shifted by -offset (the inverse permutation)."""

    @staticmethod
    def forward(ctx, t, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return axis.shift(t, offset)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.shift(g.contiguous(), -ctx.offset), None, None


class _Gather(torch.autograd.Function):
    """The pieces of the group's ranks joined along `dim`; backward, this
    rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, t, axis, dim, blocks):
        ctx.axis, ctx.dim, ctx.blocks = axis, dim, blocks
        return axis.all_gather(t, dim, blocks)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return split_part(g, ctx.dim, ctx.blocks, a.size, a.rank), None, \
            None, None


def split_part(t: torch.Tensor, dim: int, blocks: int, n: int,
               r: int) -> torch.Tensor:
    """Part `r` of `n` of `t` along `dim`, the dim read as `blocks`
    interleaved blocks (r's part of each, concatenated); contiguous, a
    4-d channels-last tensor kept channels-last."""
    dim = dim % t.dim()
    size = t.shape[dim]
    if size % (blocks * n):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {blocks} blocks of {n} parts")
    c = size // (blocks * n)
    v = t.reshape(*t.shape[:dim], blocks, n, c, *t.shape[dim + 1:])
    out = v.select(dim + 1, r).reshape(
        *t.shape[:dim], blocks * c, *t.shape[dim + 1:])
    # a copy, never a view: a slice must not keep the whole tensor alive
    return out.clone(memory_format=_format(t))


def join_parts(parts: List[torch.Tensor], dim: int,
               blocks: int) -> torch.Tensor:
    """The inverse of `split_part` over every rank's part, in rank
    order."""
    t0 = parts[0]
    dim = dim % t0.dim()
    c = t0.shape[dim] // blocks
    v = torch.stack([p.reshape(*p.shape[:dim], blocks, c, *p.shape[dim + 1:])
                     for p in parts], dim=dim + 1)
    out = v.reshape(*t0.shape[:dim], blocks * len(parts) * c,
                    *t0.shape[dim + 1:])
    return out.contiguous(memory_format=_format(t0))


def _format(t):
    """channels_last for a 4-d channels-last tensor, else contiguous."""
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


@dataclass(eq=False)
class AxisGroup:
    """One axis of the grid seen from this rank: the sub-group of the
    ranks that differ from it on that axis only, this rank's coordinate
    on it (`rank`) and the axis's size. `stats` counts the collectives
    launched through it and their bytes."""

    name: str
    group: object
    rank: int
    size: int
    stats: ReduceStats = field(default_factory=ReduceStats)
    #: the global ranks of the group's members, in group-rank order (the
    #: peers of a point-to-point hop)
    members: Tuple[int, ...] = ()

    def _count(self, t: torch.Tensor, times: int = 1) -> None:
        self.stats.collectives += 1
        self.stats.bytes += t.numel() * t.element_size() * times

    def _host(self, device: torch.device) -> bool:
        """Whether a point-to-point message on `device` goes through a
        host buffer (a CUDA tensor on gloo)."""
        return device.type == "cuda" and torch.distributed.get_backend(
            self.group) == "gloo"

    def _peer(self, r: int) -> int:
        return self.members[r] if self.members else r

    def shift(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """What rank (j - offset) mod n sent, where each rank j sends `t`
        to rank (j + offset) mod n (no autograd): every rank sends and
        receives one message, as one batch."""
        n, j = self.size, self.rank
        if offset % n == 0:
            return t.detach()
        send = t.detach().contiguous()
        device = send.device
        host = self._host(device)
        if host:
            send = send.cpu()
        recv = torch.empty_like(send)
        self._count(send)
        ops = [torch.distributed.P2POp(torch.distributed.isend, send,
                                       self._peer((j + offset) % n),
                                       self.group),
               torch.distributed.P2POp(torch.distributed.irecv, recv,
                                       self._peer((j - offset) % n),
                                       self.group)]
        for req in torch.distributed.batch_isend_irecv(ops):
            req.wait()
        return recv.to(device) if host else recv

    def shift_grad(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """`shift` (wrapping) with autograd: the backward sends the
        cotangent back by -offset."""
        return _Shift.apply(t, self, offset) if self.size > 1 else t

    def send(self, t: torch.Tensor, to: int):
        """Starts sending `t` to group rank `to`; returns a handle whose
        `wait()` ends the send (the tensor, or its host copy, is kept
        alive by the handle)."""
        buf = t.detach().contiguous()
        if self._host(buf.device):
            buf = buf.cpu()
        self._count(buf)
        return _Sent(torch.distributed.isend(buf, self._peer(to),
                                             group=self.group), buf)

    def recv(self, shape: Sequence[int], dtype: torch.dtype, device,
             frm: int) -> torch.Tensor:
        """The tensor that group rank `frm` sends (blocking)."""
        device = torch.device(device)
        host = self._host(device)
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if host else device)
        torch.distributed.recv(buf, self._peer(frm), group=self.group)
        return buf.to(device) if host else buf

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group (no autograd)."""
        out = t.detach().contiguous().clone()
        if self.size > 1:
            self._count(out)
            torch.distributed.all_reduce(out, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor, dim: int,
                   blocks: int = 1) -> torch.Tensor:
        """Every rank's `t` joined along `dim` (no autograd)."""
        t = t.detach()
        if self.size == 1:
            return t
        fmt = _format(t)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._count(t, self.size)
        torch.distributed.all_gather(parts, t, group=self.group)
        return join_parts(parts, dim, blocks).contiguous(memory_format=fmt)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(t, self) if self.size > 1 else t

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(t, self) if self.size > 1 else t

    def gather(self, t: torch.Tensor, dim: int,
               blocks: int = 1) -> torch.Tensor:
        return _Gather.apply(t, self, dim, blocks) if self.size > 1 else t

    def slice(self, t: torch.Tensor, dim: int,
              blocks: int = 1) -> torch.Tensor:
        return (split_part(t, dim, blocks, self.size, self.rank)
                if self.size > 1 else t)

    def columns_of(self, draws, width: int):
        """Draws for an activation split along its last dim: each sample
        drawn at the whole `width` and this rank's columns kept, so the
        ranks together hold the single process's sample."""
        return ColumnDraws(draws, self, width)


class _Sent:
    """An isend in flight and the buffer it reads."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self):
        self.work.wait()
        self.buf = None


class ColumnDraws:
    """An activation's draws on one rank of a split last dim (see
    `AxisGroup.columns_of`)."""

    def __init__(self, inner, axis: AxisGroup, width: int):
        self.inner, self.axis, self.width = inner, axis, width

    def _whole(self, shape):
        return (*shape[:-1], self.width)

    def bernoulli(self, p, shape):
        return self.axis.slice(self.inner.bernoulli(p, self._whole(shape)),
                               -1)

    def normal(self, shape, dtype):
        return self.axis.slice(self.inner.normal(self._whole(shape), dtype),
                               -1)


class RowDraws:
    """An activation's draws on one rank: each mask or noise sample is
    drawn for the global batch (`rows` rows) from `inner` and the rank's
    block [lo, hi) is kept."""

    def __init__(self, inner, rows: int, lo: int, hi: int):
        self.inner, self.rows, self.lo, self.hi = inner, rows, lo, hi

    def _whole(self, shape):
        if shape[0] != self.hi - self.lo:
            raise ValueError(f"an activation of {shape[0]} rows on a rank "
                             f"that holds {self.hi - self.lo}")
        return (self.rows, *shape[1:])

    def bernoulli(self, p, shape):
        return self.inner.bernoulli(p, self._whole(shape))[self.lo:self.hi]

    def normal(self, shape, dtype):
        return self.inner.normal(self._whole(shape), dtype)[self.lo:self.hi]


@dataclass
class BatchShard:
    """Rank `rank` of `world` in `group` holds rows [lo, hi) of a global
    batch of `rows` rows (padded to a multiple of `world`; `unpadded`
    before the padding)."""

    group: object
    rank: int
    world: int
    rows: int
    unpadded: int
    stats: ReduceStats = field(default_factory=ReduceStats)

    @property
    def lo(self) -> int:
        return self.rank * (self.rows // self.world)

    @property
    def hi(self) -> int:
        return self.lo + self.rows // self.world

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks (no gradient)."""
        out = t.detach().contiguous().clone()
        torch.distributed.all_reduce(out, group=self.group)
        return out

    def all_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, differentiable."""
        return _AllSum.apply(t, self.group)

    def rows_of(self, draws):
        return RowDraws(draws, self.rows, self.lo, self.hi)

    def step_draws(self, draws):
        """A training step's draws on this rank (the data axis: the
        network's own, each activation's mask then cut to the rows)."""
        return draws

    def counts_penalty(self) -> bool:
        return self.rank == 0

    def reduce(self, score: torch.Tensor, grads: List[torch.Tensor]):
        """(global score, global gradients): `grads` and the score summed
        over the ranks, packed into flat buckets of at most BUCKET_BYTES
        per dtype, one all-reduce each. Each gradient returned is a view
        of its bucket with the strides of the gradient it replaces (a
        channels-last conv gradient stays channels-last)."""
        leaves = list(grads) + [score.detach().reshape(1).float()]
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for idx in _buckets(leaves):
            dtype, device = leaves[idx[0]].dtype, leaves[idx[0]].device
            n = sum(leaves[i].numel() for i in idx)
            timed = self.stats.events is not None
            if timed:
                start = _mark(device)
            flat = torch.empty(n, dtype=dtype, device=device)
            views, off = [], 0
            for i in idx:
                v = _view_like(flat, off, leaves[i])
                v.copy_(leaves[i])
                views.append(v)
                off += leaves[i].numel()
            torch.distributed.all_reduce(flat, group=self.group)
            if timed:
                self.stats.events.append((start, _mark(device)))
            for i, v in zip(idx, views):
                out[i] = v
            self.stats.bytes += n * flat.element_size()
            self.stats.collectives += 1
        self.stats.steps += 1
        return out[-1].reshape(()), out[:-1]


@dataclass
class KeyedShard(BatchShard):
    """A shard that draws its own masks, as the JAX wrapper's seq and pipe
    steps fold their key, instead of cutting its rows from a global mask
    (`rows_of` keeps its draws). Under the seq axis rank `rank` = d *
    n_seq + s of the `world` = data x seq ranks of `group` holds the data
    axis's rows block d and the time block s of every array of the batch
    (the JAX package's shard_map over (data, seq)); the loss's global
    counts, the penalty's one count and the gradient reduce span the
    group, and the step's draws are folded by the index (`step_draws`).
    Under the pipe axis it is the data axis's shard, and the pipeline
    folds the draws per (data shard, microbatch) itself."""

    def rows_of(self, draws):
        return draws

    def step_draws(self, draws):
        """The step's draws folded by this shard's index."""
        return fold_draws(draws, self.rank)


def fold_draws(draws, *idx, salt: int = 0):
    """`draws.fold_in(i)` for each of `idx` (the JAX package's per-shard
    keys). The port's own `nn.dropout.Draws` folds to itself (one stream),
    so for it the result is a generator of its own, seeded from one draw
    of `draws`' stream, the indices and `salt`: independent draws per
    index, and the shared stream advances by one draw per call alike on
    every rank."""
    from deeplearning4j_tpu_torch.nn.dropout import Draws

    if not isinstance(draws, Draws):
        for i in idx:
            draws = draws.fold_in(i)
        return draws
    g = draws.generator
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=g,
                             device=g.device).item())
    for i in (*idx, salt):
        seed = (seed * 1000003 + int(i) + 1) % 2 ** 62
    return Draws.seeded(seed, g.device)


def broadcast(tensors: List[torch.Tensor], src: int, group) -> None:
    """Every tensor set in place to rank `src`'s, through flat buckets (one
    broadcast each)."""
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        torch.distributed.broadcast(flat, src=src, group=group)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def _mark(device):
    if device.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _buckets(leaves):
    """Index lists of `leaves` grouped by (dtype, device), in order, each
    at most BUCKET_BYTES (a larger leaf alone)."""
    groups = {}
    for i, t in enumerate(leaves):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out = []
    for idx in groups.values():
        cur, size = [], 0
        for i in idx:
            nbytes = leaves[i].numel() * leaves[i].element_size()
            if cur and size + nbytes > BUCKET_BYTES:
                out.append(cur)
                cur, size = [], 0
            cur.append(i)
            size += nbytes
        out.append(cur)
    return out


def _view_like(flat, off, t):
    """flat[off:off + t.numel()] as a tensor of t's shape and memory
    format (channels-last for a channels-last 4-d t)."""
    chunk = flat[off:off + t.numel()]
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        n, c, h, w = t.shape
        return chunk.view(n, h, w, c).permute(0, 3, 1, 2)
    return chunk.view(t.shape)


_STATE = threading.local()


class installed:
    """Makes `shard` the data-parallel shard of the training steps run in
    this block (thread-local); `active` turns it on around a step's loss
    and gradients."""

    def __init__(self, shard: BatchShard):
        self.shard = shard

    def __enter__(self):
        self._prev = getattr(_STATE, "installed", None)
        _STATE.installed = self.shard
        return self.shard

    def __exit__(self, *exc):
        _STATE.installed = self._prev
        return False


class splitting:
    """Inside: `model_split()` is `axis` (a layer computing on its model
    shards; None for a layer that does not)."""

    def __init__(self, axis: Optional[AxisGroup]):
        self.axis = axis

    def __enter__(self):
        self._prev = getattr(_STATE, "split", None)
        _STATE.split = self.axis
        return self.axis

    def __exit__(self, *exc):
        _STATE.split = self._prev
        return False


def model_split() -> Optional[AxisGroup]:
    """The model axis of the layer being applied when its params are split
    over it and it computes on its shards, else None."""
    return getattr(_STATE, "split", None)


def installed_shard() -> Optional[BatchShard]:
    """The shard the wrapper installed around this batch, or None."""
    return getattr(_STATE, "installed", None)


class active:
    """Inside: `current()` is the installed shard (if any)."""

    def __enter__(self):
        self._prev = getattr(_STATE, "active", False)
        _STATE.active = True
        return installed_shard()

    def __exit__(self, *exc):
        _STATE.active = self._prev
        return False


def current() -> Optional[BatchShard]:
    """The shard of the training step being computed, or None (no wrapper,
    or outside the step's loss and gradients)."""
    if not getattr(_STATE, "active", False):
        return None
    return installed_shard()
