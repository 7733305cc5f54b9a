"""The data axis of the device mesh on torch.distributed (counterpart of
deeplearning4j_tpu/parallel/mesh.py:35-74).

The JAX package lays its devices out as a `jax.sharding.Mesh` over seven
axes inside one process. The port runs one process per rank, so the mesh
is the process group that joins them: `build_mesh` returns the data group
(`DataGroup`: the group, this process's rank in it and its size). Only the
data axis is ported; any other axis greater than 1 raises
NotImplementedError (ROADMAP A.9).

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
from typing import Dict, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import device as device_mod

AXES = ("dcn", "data", "fsdp", "model", "pipe", "seq", "expert")

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


@dataclass(frozen=True)
class DataGroup:
    """The data axis: the process group, this process's rank in it and
    the number of ranks."""

    group: object
    rank: int
    size: int
    backend: str


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


def build_mesh(spec: Optional[MeshSpec] = None) -> DataGroup:
    """The data group of `spec` (default: every rank on the data axis) over
    the initialised process group. Raises NotImplementedError for any
    other axis greater than 1, and ValueError when `spec.data` is not the
    group's world size."""
    spec = spec or MeshSpec.data_parallel()
    others = {a: n for a, n in spec.axis_sizes().items()
              if a != "data" and n > 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {others}: only the data axis is ported; the model, "
            f"seq, pipe, fsdp, dcn and expert axes are queued in ROADMAP "
            f"A.9")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.mesh."
                           "init_process_group first")
    world = dist.get_world_size()
    if spec.data != world:
        raise ValueError(f"mesh spec {spec.axis_sizes()} needs "
                         f"{spec.total()} ranks, the process group has "
                         f"{world}")
    return DataGroup(dist.group.WORLD, dist.get_rank(), world,
                     str(dist.get_backend()))
