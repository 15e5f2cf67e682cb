"""Multi-process runtime glue (twin of `rgbd360_tpu/parallel/multihost.py`),
on `torch.distributed`.

The reference wraps `jax.distributed`; here a job is a set of processes, one
per rank, that join one process group:

  * `initialize()`: `torch.distributed.init_process_group` from explicit
    arguments or torchrun's environment; a no-op in a single-process run.
  * `global_mesh(axis)`: the one-axis mesh over every rank of the job; the
    sharded stages of `parallel/sharded.py` take any such mesh.
  * `hosts_mesh()`: a 2-D (host, device) mesh of subgroups, for reductions
    that go within a host first and across hosts second.
  * `host_local_to_global` / `global_to_host_local`: boundary converters
    between a rank's piece of an array and the whole array (every rank
    holds the whole array: the port's sharded programs are SPMD with
    replicated inputs).
  * `all_hosts_agree`: a cheap check that a control decision (keyframe
    insertion, loop-closure acceptance) came out the same on every rank.

The backend is the caller's choice and is never switched: "nccl" for one
rank per card, "gloo" for ranks on the CPU or for several ranks that share
one card (NCCL refuses two ranks on one device; gloo reduces CUDA tensors
through the host).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from rgbd360_tpu_torch.parallel.sharded import Mesh, all_gather, make_mesh


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
) -> bool:
    """Join the job's process group if this is a multi-process run; returns
    True when distributed mode is active (more than one rank).

    Explicit arguments first, then torchrun's environment (`WORLD_SIZE`,
    `RANK`, and `MASTER_ADDR` / `MASTER_PORT` through `env://`).  With a
    world of one (or none named) this is a no-op returning False.  A
    multi-process run must name its `backend`."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or world_size <= 1:
        return False
    if rank is None:
        raise ValueError(f"a world of {world_size} ranks needs this process's rank (RANK)")
    if backend is None:
        raise ValueError(
            'name the backend: "nccl" for one rank per card, "gloo" for the CPU '
            "or for several ranks on one card"
        )
    if init_method is None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
            raise ValueError("no init_method and no MASTER_ADDR / MASTER_PORT to rendezvous at")
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return world_size > 1


def global_mesh(axis: str = "kf", device=None) -> Mesh:
    """The one-axis mesh over every rank of the job (a world of one in a
    single-process run)."""
    return make_mesh(axis=axis, device=device)


@dataclass(frozen=True, eq=False)
class HostsMesh:
    """A 2-D (host, device) mesh: `shape` is (hosts, ranks per host); the
    mesh along each axis is this rank's row or column, a subgroup."""

    shape: tuple[int, int]
    axes: dict

    def __getitem__(self, axis: str) -> Mesh:
        return self.axes[axis]


def hosts_mesh(host_axis: str = "host", device_axis: str = "device", device=None) -> HostsMesh:
    """The (host, device) mesh: rows are hosts (ranks grouped by host
    name, in rank order), columns the ranks of a host.  Every rank must
    call it (it creates the subgroups collectively)."""
    dev = None if device is None else torch.device(device)
    if not dist.is_initialized():
        return HostsMesh((1, 1), {host_axis: Mesh(None, 0, 1, host_axis, dev),
                                  device_axis: Mesh(None, 0, 1, device_axis, dev)})
    world, rank = dist.get_world_size(), dist.get_rank()
    names: list = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    hosts = list(dict.fromkeys(names))
    grid = [[r for r in range(world) if names[r] == h] for h in hosts]
    per = len(grid[0])
    if any(len(row) != per for row in grid):
        raise ValueError(f"hosts hold unequal numbers of ranks: {[len(r) for r in grid]}")
    axes = {}
    for row in grid:  # one subgroup per host (every rank creates every group)
        g = dist.new_group(row)
        if rank in row:
            axes[device_axis] = Mesh(g, row.index(rank), per, device_axis, dev)
    for c in range(per):
        col = [row[c] for row in grid]
        g = dist.new_group(col)
        if rank in col:
            axes[host_axis] = Mesh(g, col.index(rank), len(grid), host_axis, dev)
    return HostsMesh((len(grid), per), axes)


def host_local_to_global(mesh: Mesh, dim: int, local: torch.Tensor) -> torch.Tensor:
    """The whole array from every rank's piece (the pieces concatenated
    along `dim` in rank order), on every rank.  The pieces must have the
    same shape."""
    return all_gather(mesh, local.movedim(dim, 0)).movedim(0, dim)


def global_to_host_local(mesh: Mesh, dim: int, global_array: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the whole array along `dim` (the inverse of
    `host_local_to_global`)."""
    lo, hi = mesh.block(global_array.shape[dim], f"dimension {dim}")
    return global_array.narrow(dim, lo, hi - lo)


def all_hosts_agree(value, mesh: Mesh | None = None) -> bool:
    """True iff every rank computed the same scalar `value`: its largest
    and smallest value over the ranks are equal (two all-reduces).  Always
    True in a world of one."""
    group = mesh.group if mesh is not None else (dist.group.WORLD if dist.is_initialized() else None)
    if group is None:
        return True
    # NCCL reduces only CUDA tensors; gloo takes host ones directly
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    hi = torch.tensor([float(value)], dtype=torch.float64, device=device)
    lo = hi.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(hi.item() == lo.item())
