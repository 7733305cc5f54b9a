"""The device mesh on torch.distributed, and the placement of params over
it (counterpart of deeplearning4j_tpu/parallel/mesh.py).

The JAX package lays its devices out as a `jax.sharding.Mesh` over seven
axes inside one process. The port runs one process per rank, so the mesh
is a grid of ranks: `build_mesh` lays the initialised group's ranks out
row-major in the JAX axis order (dcn, data, fsdp, model, pipe, seq,
expert), as `mesh.py` reshapes its devices, and creates one sub-group per
line of each axis and of each combination a step reduces over (every rank
creates every group, in one order, as torch.distributed asks; lines with
the same ranks share one group). It returns a `Grid`: this rank's
coordinates and its `nn.shard.AxisGroup` on the data, fsdp, model, pipe,
seq and expert axes, on `shard` (the fsdp x model ranks of its data
coordinate), on `batch` (data x seq: the ranks that split one step's
batch, rows over data and time over seq, whose loss counts, penalty count,
BatchNorm statistics and gradient reduce a step takes) and on `replica`
(data x seq x pipe: the reduce of a pipeline's stage-replicated
gradients). Every axis works but dcn: a dcn axis greater than 1 raises
NotImplementedError (ROADMAP A.9's rest).

There is no NamedSharding: where the JAX package places a leaf with a
PartitionSpec, the port holds a `Placement`, the same spec as a tuple of
axis names over the leaf's interchange layout (the JAX package's: conv
kernels HWIO), the port dim each interchange dim is held in, and the
interleaved blocks of a model-split dim. A rank holds its slice of each
split dim (`Placement.local`); `replicated`, `batch_sharding`,
`shard_batch_tree`, `param_partition_spec`, `model_param_shardings`,
`mirror_opt_shardings` and `shard_params_tree` are the JAX helpers over
placements.

The group is initialised by the caller, from explicit arguments
(`init_process_group`: backend, rank, world size and a `file://` or
`tcp://` localhost rendezvous); nothing here reads a cluster's
environment. NCCL joins CUDA networks and gloo CPU networks; a caller may
initialise gloo for CUDA tensors (NCCL refuses two ranks on one device).
Nothing switches backends silently: a failed initialisation raises.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import device as device_mod
from deeplearning4j_tpu_torch.models._training import flat_items
from deeplearning4j_tpu_torch.nn import shard as shard_mod

AXES = ("dcn", "data", "fsdp", "model", "pipe", "seq", "expert")

# the sub-groups of a grid: an AxisGroup each, over these axes
GROUPS = (("dcn", ("dcn",)), ("data", ("data",)), ("fsdp", ("fsdp",)), ("model", ("model",)),
          ("pipe", ("pipe",)), ("seq", ("seq",)), ("expert", ("expert",)),
          ("shard", ("fsdp", "model")), ("batch", ("data", "seq")),
          ("replica", ("data", "seq", "pipe")))

# how long a rank waits for the others at the rendezvous and in a
# collective before it raises (a rank that died leaves the rest waiting)
TIMEOUT = datetime.timedelta(seconds=300)


@dataclass
class MeshSpec:
    data: int = 1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    dcn: int = 1
    fsdp: int = 1

    def total(self) -> int:
        return (self.dcn * self.data * self.fsdp * self.model * self.pipe
                * self.seq * self.expert)

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    @staticmethod
    def data_parallel(n: Optional[int] = None) -> "MeshSpec":
        """All ranks on the data axis: `n`, else the initialised group's
        world size, else the CUDA devices here (at least 1)."""
        if n is None:
            n = (dist.get_world_size() if dist.is_initialized()
                 else max(1, torch.cuda.device_count()))
        return MeshSpec(data=n)


@dataclass(eq=False)
class Grid:
    """The mesh from one rank: the spec, the global group (`group`,
    `rank`, `size`, `backend`), this rank's coordinate on every axis and
    its AxisGroup on each of `GROUPS`: the data, fsdp, model, pipe, seq
    and expert axes, `shard` (fsdp x model), `batch` (data x seq) and
    `replica` (data x seq x pipe), and the dcn axis (the same coordinate
    on every other axis; no step reduces over it)."""

    spec: MeshSpec
    group: object
    rank: int
    size: int
    backend: str
    coords: Dict[str, int]
    dcn: shard_mod.AxisGroup
    data: shard_mod.AxisGroup
    fsdp: shard_mod.AxisGroup
    model: shard_mod.AxisGroup
    pipe: shard_mod.AxisGroup
    seq: shard_mod.AxisGroup
    expert: shard_mod.AxisGroup
    shard: shard_mod.AxisGroup
    batch: shard_mod.AxisGroup
    replica: shard_mod.AxisGroup

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes, as `jax.sharding.Mesh.shape`."""
        return self.spec.axis_sizes()

    def axis(self, name: str) -> shard_mod.AxisGroup:
        return getattr(self, name)


def init_process_group(init_method: str, rank: int, world_size: int,
                       backend: Optional[str] = None, device=None) -> str:
    """Joins this process to the group as `rank` of `world_size` through
    `init_method`, a `file://` path or a `tcp://127.0.0.1:<port>` (or
    localhost) address. `backend` defaults to "nccl" for a CUDA `device`
    (None is the card, as at every entry point) and "gloo" for the CPU;
    for NCCL the device becomes the current CUDA device. Returns the
    backend."""
    if not (init_method.startswith("file://")
            or init_method.startswith("tcp://127.0.0.1:")
            or init_method.startswith("tcp://localhost:")):
        raise ValueError(f"rendezvous {init_method!r}: use a file:// path "
                         f"or tcp://127.0.0.1:<port>")
    dev = device_mod.resolve(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend joins CUDA devices; use "
                             "gloo for the CPU")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return backend


def check_spec(spec: MeshSpec) -> None:
    """Raises ValueError for an axis of fewer than one rank; every axis,
    dcn included, runs."""
    bad = {a: n for a, n in spec.axis_sizes().items()
           if not isinstance(n, int) or n < 1}
    if bad:
        raise ValueError(f"mesh axes {bad}: each axis holds at least one "
                         f"rank")


def build_mesh(spec: Optional[MeshSpec] = None) -> Grid:
    """The grid of `spec` (default: every rank on the data axis) over the
    initialised process group. Raises ValueError when `spec.total()` is
    not the group's world size."""
    spec = spec or MeshSpec.data_parallel()
    check_spec(spec)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.mesh."
                           "init_process_group first")
    world, me = dist.get_world_size(), dist.get_rank()
    if spec.total() != world:
        raise ValueError(f"mesh spec {spec.axis_sizes()} needs "
                         f"{spec.total()} ranks, the process group has "
                         f"{world}")
    sizes = [getattr(spec, a) for a in AXES]
    ranks = np.arange(world).reshape(sizes)
    coords = {a: int(c) for a, c in zip(
        AXES, np.unravel_index(me, sizes))}

    made = {}

    def lines(axes):
        """Every group of ranks that differ on `axes` only, in one
        order; this rank's (group, rank in it, members). An axis of one
        rank makes no group (its AxisGroup runs no collective), but the
        data axis's, the batch's and the replica's, which a gradient
        reduce always uses. Lines with the same ranks as an earlier one
        reuse its group."""
        idx = [AXES.index(a) for a in axes]
        rest = [i for i in range(len(AXES)) if i not in idx]
        moved = np.moveaxis(ranks, idx + rest, list(range(len(AXES))))
        flat = moved.reshape(int(np.prod([sizes[i] for i in idx])), -1)
        if flat.shape[0] == 1 and axes[0] != "data":
            return None, 0, (me,)
        mine = None
        for col in range(flat.shape[1]):
            members = tuple(int(r) for r in flat[:, col])
            if members not in made:
                made[members] = (dist.group.WORLD if len(members) == world
                                 else dist.new_group(list(members)))
            if me in members:
                mine = (made[members], members.index(me), members)
        return mine

    groups = {}
    for name, axes in GROUPS:
        g, r, members = lines(axes)
        groups[name] = shard_mod.AxisGroup(name, g, r, len(members),
                                           members=members)
    return Grid(spec, dist.group.WORLD, me, world,
                str(dist.get_backend()), coords, **groups)


# ---------------------------------------------------------------- placement
@dataclass(frozen=True)
class Placement:
    """Where a leaf lives on the grid. `spec`: one entry per dim of the
    leaf's interchange layout, None (whole) or the axis it is split over
    (the JAX PartitionSpec as a tuple; () replicates). `dims`: the port
    dim each interchange dim is held in (None: the same). `blocks`: the
    interleaved blocks of a model-split dim (`nn.shard.split_part`)."""

    spec: Tuple = ()
    dims: Optional[Tuple[int, ...]] = None
    blocks: int = 1

    def port_dim(self, axis: str) -> Optional[int]:
        """The port dim split over `axis`, or None."""
        for i, e in enumerate(self.spec):
            if e == axis:
                return i if self.dims is None else self.dims[i]
        return None

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(e for e in self.spec if e is not None)

    def with_spec(self, spec) -> "Placement":
        return Placement(tuple(spec), self.dims, self.blocks)

    def local(self, t: torch.Tensor, grid: Grid) -> torch.Tensor:
        """This rank's slice of the whole leaf `t`: its model part, then
        its fsdp part."""
        for axis in ("model", "fsdp"):
            d = self.port_dim(axis)
            if d is not None:
                t = grid.axis(axis).slice(
                    t, d, self.blocks if axis == "model" else 1)
        return t

    def whole(self, t: torch.Tensor, grid: Grid) -> torch.Tensor:
        """The whole leaf from this rank's slice `t` (collective over the
        leaf's axes; no autograd)."""
        for axis in ("fsdp", "model"):
            d = self.port_dim(axis)
            if d is not None:
                t = grid.axis(axis).all_gather(
                    t, d, self.blocks if axis == "model" else 1)
        return t


REPLICATED = Placement()


def replicated(mesh: Optional[Grid] = None) -> Placement:
    return REPLICATED


def batch_sharding(mesh: Optional[Grid] = None, ndim: int = 2) -> Placement:
    """Axis 0 over 'data', the rest whole."""
    return Placement(("data",) + (None,) * (ndim - 1))


def shard_batch_tree(mesh: Grid, tree):
    """This rank's rows of every array of a nested dict, list or tuple
    (None kept): the data axis's contiguous block, as `device_put` with
    `batch_sharding` gives each JAX device."""
    def put(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        ax = mesh.data
        n = x.shape[0]
        if n % ax.size:
            raise ValueError(f"a batch of {n} rows over {ax.size} data "
                             f"ranks")
        per = n // ax.size
        return x[ax.rank * per:(ax.rank + 1) * per]

    return put(tree)


def param_partition_spec(path: str, shape: Tuple[int, ...],
                         model_size: int) -> Tuple:
    """The generic tensor-parallel rule: the last axis over 'model' when it
    divides and is at least twice the axis; everything else, biases and
    small vectors included, replicates."""
    if model_size <= 1 or not shape:
        return ()
    last = shape[-1]
    if len(shape) >= 2 and last % model_size == 0 and last >= 2 * model_size:
        return (None,) * (len(shape) - 1) + ("model",)
    return ()


def _layer_placements(layer, params, model_size):
    """{path: Placement} of one layer's params from its declared specs."""
    specs = layer.tensor_partition_specs(params, "model", model_size)
    out = {}
    for path, _ in flat_items(params):
        spec = tuple(leaf_at(specs, path))
        out[path] = Placement(spec, layer.interchange_dims(path),
                              layer.split_blocks(path))
    return out


def model_param_shardings(mesh: Grid, model, model_axis: str = "model"):
    """{key: {path: Placement}} for a MultiLayerNetwork's or a
    ComputationGraph's params from the LAYER-DECLARED tensor-parallel
    specs (`Layer.tensor_partition_specs`); a graph vertex that is not a
    layer replicates."""
    msize = mesh.shape.get(model_axis, 1)
    out = {}
    for key, p in model.params.items():
        layer = model.layer(key)
        if layer is None:
            out[key] = {path: REPLICATED for path, _ in flat_items(p)}
        else:
            out[key] = _layer_placements(layer, p, msize)
    return out


def mirror_opt_shardings(mesh: Optional[Grid], opt_entry, param_shardings):
    """Placements for ONE updater-state entry: a slot whose paths are the
    params' (Adam's m and v, momentum's v) takes the param placements;
    scalars (Adam's t) and anything else replicate."""
    want = sorted(param_shardings)

    def mirrors(tree) -> bool:
        return isinstance(tree, dict) and sorted(
            p for p, _ in flat_items(tree)) == want

    if isinstance(opt_entry, dict):
        return {k: (dict(param_shardings) if mirrors(v) else
                    ({p: REPLICATED for p, _ in flat_items(v)}
                     if isinstance(v, dict) else REPLICATED))
                for k, v in opt_entry.items()}
    return REPLICATED


def shard_params_tree(mesh: Grid, params, model_axis: str = "model"):
    """`param_partition_spec` over a nested param dict: {path:
    Placement}."""
    m = mesh.shape[model_axis]
    return {path: Placement(param_partition_spec(path, tuple(t.shape), m))
            for path, t in flat_items(params)}


def leaf_at(tree, path: str):
    """The leaf of a nested dict at a '/'-joined path."""
    for part in path.split("/"):
        tree = tree[part]
    return tree
