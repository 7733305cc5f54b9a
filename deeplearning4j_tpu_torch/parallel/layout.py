"""Per-tensor parameter layouts over the fsdp x model axes, and the remat
(activation checkpoint) policies (counterpart of
deeplearning4j_tpu/parallel/layout.py).

Layout rules (SpecLayout): the layer declares its tensor-parallel spec
(`Layer.tensor_partition_specs`, through `mesh.model_param_shardings`);
`SpecLayout.extend` composes the fsdp axis onto it, on the first of the
largest free dims that the fsdp axis divides and that is at least twice
it, as the JAX package picks: embedding tables split their vocab axis,
dense and attention kernels their input axis, conv kernels their channel
axis; vectors (norm scales, biases) replicate. With fsdp 1 nothing
changes.

Gather-on-use (ZeRO-3): params LIVE sharded over fsdp (and model); each
layer's subtree is gathered right before the layer runs
(`FsdpArrangement.gather`, an all-gather whose backward keeps this rank's
slice of the gradient), inside the layer's remat scope, so under a remat
policy the backward gathers again instead of keeping the whole weights.
The ranks of an fsdp line hold the same rows (the batch splits over the
data axis only), so each gathered param's gradient is the same on each of
them and each keeps its slice; the data axis's bucketed reduce sums it
over the data axis. Updater slots mirror their params' placement
(`mesh.mirror_opt_shardings`), so params, gradients and slots are all
1/(fsdp x model)-sized at rest where they split.

Remat policies: a layer's `remat` names one (`canonical_policy`; True is
'full', False and None are 'none'):

    'none'            no checkpoint
    'dots_saveable'   a selective checkpoint that saves the products' and
                      convolutions' outputs and recomputes the rest
    'full'            torch.utils.checkpoint (non-reentrant): saves
                      nothing, recomputes the layer in the backward
    'offload'         torch.autograd.graph.save_on_cpu(pin_memory=True):
                      the saved activations go to host memory

A recompute replays the draws of the first pass (`nn.dropout.Recorded`):
torch.utils.checkpoint restores the default generators only, not a
network's own `torch.Generator`, so without the replay a layer's dropout
mask would differ between the forward and its recompute. It also runs
under the step's thread state of the first pass (the installed batch
shard, whether it is active, the iteration): on a CUDA tensor the
backward, and so the recompute, runs on autograd's device thread, which
holds none of the calling thread's (nor its sequence-parallel context,
which the recompute re-enters too).
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from deeplearning4j_tpu_torch.nn import dropout as drop_mod
from deeplearning4j_tpu_torch.nn import shard as shard_mod
from deeplearning4j_tpu_torch.nn.layers import base as base_mod
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod

# ---------------------------------------------------------------------------
# remat policy registry
# ---------------------------------------------------------------------------

#: policy names, weakest to strongest activation saving
REMAT_POLICY_NAMES = ("none", "dots_saveable", "full", "offload")

#: the ops whose outputs 'dots_saveable' keeps (jax.checkpoint_policies.
#: dots_saveable: the dot_generals and convolutions)
_DOTS = ("mm", "addmm", "bmm", "baddbmm", "convolution",
         "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_flash_attention",
         "_scaled_dot_product_cudnn_attention",
         "_scaled_dot_product_flash_attention_for_cpu")

_POLICY_CACHE: Dict[str, Any] = {}


def canonical_policy(name: Any) -> str:
    """A remat selector (None, a bool or a name) as a canonical name."""
    if name is None or name is False or name == "none":
        return "none"
    if name is True or name == "full":
        return "full"
    n = str(name)
    if n in REMAT_POLICY_NAMES:
        return n
    raise ValueError(
        f"unknown remat policy {name!r}; choose one of "
        f"{REMAT_POLICY_NAMES} (or a bool: True='full', False='none')")


def _dots_saveable(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    name = getattr(op, "__name__", str(op)).split(".")[0]
    return (CheckpointPolicy.MUST_SAVE if name in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name: Any):
    """What a canonical name runs under: None for 'none' and 'full' (a
    checkpoint saves nothing), the selective-checkpoint `context_fn` for
    'dots_saveable', the string 'offload' for the host stash. The same
    name gives the same object."""
    n = canonical_policy(name)
    if n not in _POLICY_CACHE:
        if n == "dots_saveable":
            from torch.utils.checkpoint import (
                create_selective_checkpoint_contexts,
            )

            pol = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_saveable)
        elif n == "offload":
            pol = "offload"
        else:
            pol = None
        _POLICY_CACHE[n] = pol
    return _POLICY_CACHE[n]


def maybe_remat(fn: Callable, name: Any) -> Callable:
    """`fn(*args, rng=draws)` under the named policy; `fn` itself for
    'none'. Under 'full' and 'dots_saveable' the recompute replays the
    first pass's draws."""
    n = canonical_policy(name)
    if n == "none":
        return fn
    if n == "offload":
        def offloaded(*args, rng=None):
            with torch.autograd.graph.save_on_cpu(pin_memory=True):
                return fn(*args, rng=rng)

        return offloaded
    context_fn = remat_policy(n)

    def checkpointed(*args, rng=None):
        from torch.utils.checkpoint import checkpoint

        tape = None if rng is None else drop_mod.Recorded(rng)
        again = _step_state()

        def run(*a):
            with again():
                return fn(*a, rng=None if tape is None else tape.rewound())

        kw = {} if context_fn is None else {"context_fn": context_fn}
        return checkpoint(run, *args, use_reentrant=False, **kw)

    return checkpointed


def _step_state():
    """A context that re-enters this thread's step state (the installed
    batch shard, whether it is active, the iteration, the seq axis of a
    sequence-parallel step), for a recompute that may run on another
    thread."""
    from deeplearning4j_tpu_torch.parallel import ring

    shard = shard_mod.installed_shard()
    on = shard_mod.current() is not None
    iteration = base_mod.current_iteration()
    seq = ring.active_sequence_axis()

    @contextlib.contextmanager
    def again():
        with shard_mod.installed(shard), base_mod.iteration_scope(
                iteration), (shard_mod.active() if on
                             else contextlib.nullcontext()), (
                ring.sequence_parallel(seq) if seq is not None
                else contextlib.nullcontext()):
            yield

    return again


# ---------------------------------------------------------------------------
# fsdp spec layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpecLayout:
    """Per-tensor layout rules over the fsdp and model axes. `extend` takes
    a layer-declared tensor-parallel spec (a tuple) and adds the fsdp axis
    on the first of the largest free dims that divide by it."""

    fsdp_axis: str = "fsdp"
    model_axis: str = "model"

    def extend(self, spec: Tuple, shape: Tuple[int, ...],
               fsdp_size: int) -> Tuple:
        if fsdp_size <= 1 or len(shape) < 2:
            return tuple(spec)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        best = None  # (size, dim)
        for dim, size in enumerate(shape):
            if entries[dim] is not None:
                continue  # the dim carries a mesh axis (tp)
            if size % fsdp_size or size < 2 * fsdp_size:
                continue
            if best is None or size > best[0]:
                best = (size, dim)
        if best is None:
            return tuple(spec)
        entries[best[1]] = self.fsdp_axis
        return tuple(entries)

    def drop_fsdp(self, spec: Tuple) -> Tuple:
        """The gather-on-use target: the spec without the fsdp axis."""
        def strip(e):
            if e == self.fsdp_axis:
                return None
            if isinstance(e, (tuple, list)):
                kept = tuple(a for a in e if a != self.fsdp_axis)
                return kept if kept else None
            return e

        return tuple(strip(e) for e in spec)


DEFAULT_LAYOUT = SpecLayout()


def fsdp_param_specs(mesh: mesh_mod.Grid, model,
                     layout: SpecLayout = DEFAULT_LAYOUT):
    """{key: {path: Placement}} for a MultiLayerNetwork or a
    ComputationGraph: the layer-declared tensor-parallel placements with
    the fsdp axis composed on by `layout.extend` (over each param's
    interchange shape)."""
    fsdp_size = mesh.shape.get(layout.fsdp_axis, 1)
    base = mesh_mod.model_param_shardings(mesh, model)
    out = {}
    for key, tree in base.items():
        layer = model.layer(key)
        out[key] = {}
        for path, pl in tree.items():
            t = mesh_mod.leaf_at(model.params[key], path)
            shape = tuple(t.shape) if layer is None else tuple(
                _interchange_shape(layer, path, t))
            out[key][path] = pl.with_spec(
                layout.extend(pl.spec, shape, fsdp_size))
    return out


def _interchange_shape(layer, path, t):
    dims = layer.interchange_dims(path)
    if dims is None:
        return t.shape
    return [t.shape[d] for d in dims]


class FsdpArrangement:
    """The placement of a network's params on the grid, attached to it (as
    `model._shard_layout`) by ParallelWrapper when the fsdp or the model
    axis is above 1. `placements`: {key: {path: Placement}}, sharded at
    rest. The network's forward asks `gather` for each layer's params
    right before use; `scatter` and `shard_tree` cut whole params (or
    gradients) to this rank's slices; `whole` gathers a subtree back
    (no autograd), for the param table, checkpoints and saves."""

    def __init__(self, mesh: mesh_mod.Grid, placements,
                 layout: SpecLayout = DEFAULT_LAYOUT):
        self.mesh = mesh
        self.layout = layout
        self.placements = placements
        self.specs = {k: {p: pl.spec for p, pl in tree.items()}
                      for k, tree in placements.items()}

    def placement(self, key: str, path: str) -> mesh_mod.Placement:
        return self.placements.get(key, {}).get(path, mesh_mod.REPLICATED)

    def splits(self, key: str, axis: str) -> bool:
        """Whether any param of `key` is split over `axis`."""
        return any(pl.port_dim(axis) is not None
                   for pl in self.placements.get(key, {}).values())

    def _map(self, key, subtree, fn, prefix=""):
        return {k: (self._map(key, v, fn, f"{prefix}{k}/")
                    if isinstance(v, dict)
                    else fn(self.placement(key, prefix + k), v))
                for k, v in subtree.items()}

    def gather(self, key: str, subtree, model: bool = False):
        """Gather-on-use: every fsdp-split param of `key` gathered along
        its fsdp dim, and with `model` every model-split one along its
        model dim too (differentiable: the backward keeps this rank's
        slice)."""
        mesh = self.mesh

        def one(pl, t):
            d = pl.port_dim(self.layout.fsdp_axis)
            if d is not None:
                t = mesh.fsdp.gather(t, d)
            d = pl.port_dim(self.layout.model_axis)
            if model and d is not None:
                t = mesh.model.gather(t, d, pl.blocks)
            return t

        return self._map(key, subtree, one)

    def scatter(self, key: str, subtree):
        """This rank's slices of a whole subtree of `key`."""
        return self._map(key, subtree, lambda pl, t: pl.local(t, self.mesh))

    def shard_tree(self, tree):
        """`scatter` over a whole tree keyed like `model.params`."""
        return {k: self.scatter(k, v) for k, v in tree.items()}

    def place(self, model, params: bool = True, slots: bool = True):
        """Cut `model`'s whole params (with `params`) and the updater slots
        that mirror them (with `slots`) to this rank's slices, and make
        this arrangement the model's layout. Scalar slots (Adam's t) and
        running state stay whole."""
        with torch.no_grad():
            if params:
                model.params = self.shard_tree(model.params)
            if slots:
                keys = list(model.params)
                listed = not isinstance(model.opt_state, dict)
                entries = (zip(keys, model.opt_state) if listed
                           else model.opt_state.items())
                placed = {}
                for key, entry in entries:
                    if isinstance(entry, dict):
                        mirror = mesh_mod.mirror_opt_shardings(
                            self.mesh, entry, self.placements.get(key, {}))
                        entry = {slot: (self.scatter(key, v)
                                        if isinstance(v, dict) and any(
                                            pl.axes for pl in
                                            mirror[slot].values())
                                        else v)
                                 for slot, v in entry.items()}
                    placed[key] = entry
                model.opt_state = ([placed[k] for k in keys] if listed
                                   else placed)
        model._shard_layout = self

    def whole(self, key: str, subtree):
        """The whole params of `key` from this rank's slices (collective
        over their axes, no autograd)."""
        return self._map(key, subtree, lambda pl, t: pl.whole(t, self.mesh))

    def global_sum(self, key: str, terms: Dict[str, torch.Tensor]):
        """sum over the whole params of `key` of per-param terms that add
        over a param's entries (|w|, w^2): `terms` maps a path to this
        rank's term of its slice. The value counts every slice once
        (replicated params once), summed over the shard group; the
        gradient is that of this rank's own terms, so each rank's slice
        gets its whole gradient."""
        mesh = self.mesh
        local, split = None, None
        counted = None
        for path, v in terms.items():
            axes = self.placement(key, path).axes
            if not axes:
                local = v if local is None else local + v
                continue
            split = v if split is None else split + v
            # a slice held on several ranks of the shard group (split
            # over one axis, whole over the other) counts on coordinate 0
            # of the axis it is whole over
            own = all(mesh.axis(a).rank == 0 for a in ("fsdp", "model")
                      if a not in axes)
            w = v.detach() if own else torch.zeros_like(v.detach())
            counted = w if counted is None else counted + w
        if split is None:
            return local
        total = split + (mesh.shard.all_sum(counted) - split.detach())
        return total if local is None else local + total


def apply_layer(arrangement, key: str, layer, params, fn: Callable,
                *inputs, remat=None, rng=None):
    """`fn(p, *inputs, rng=rng)` for one layer, inside the scope of the
    remat policy `remat` (None: no checkpoint; a network passes its
    layer's at train time). With an `arrangement` the params are gathered
    on use inside that scope, so a checkpointed layer's backward gathers
    again: the fsdp slices, and the model slices unless the layer computes
    on them, which it then does inside `nn.shard.splitting`. A layer with
    weight noise takes them whole: the noise is drawn for the whole
    param. `fn` must not read a caller's loop variables: a recompute calls
    it after the loop has moved on, with these `inputs`."""
    def run(p_raw, *a, rng=None):
        if arrangement is None:
            return fn(p_raw, *a, rng=rng)
        tp = (arrangement.mesh.model if arrangement.splits(key, "model")
              else None)
        whole = tp is not None and (
            not getattr(layer, "computes_model_shards", False)
            or getattr(layer, "weight_noise", None) is not None)
        p = arrangement.gather(key, p_raw, model=whole)
        with shard_mod.splitting(None if whole else tp):
            return fn(p, *a, rng=rng)

    if remat:
        run = maybe_remat(run, remat)
    return run(params, *inputs, rng=rng)
