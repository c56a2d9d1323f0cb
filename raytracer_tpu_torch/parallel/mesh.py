"""The rank mesh for multi-device rendering (PyTorch port of
``raytracer_tpu/parallel/mesh.py``).

The parallel decomposition of the pixel domain generalizes the
reference's progressive row cursor (reference: raytracer/mod.rs:87-115):
ray batches shard over a 1-D `rays` axis of ranks, the scene is
replicated on every rank.  A rank is one process of a
`torch.distributed` process group with one device: NCCL between CUDA
cards, gloo between CPU processes.

Call `initialize_distributed(...)` on every rank first; `make_mesh()`
then spans the group.  A `Mesh` built by hand with no group is a view of
one rank, for replaying a rank's share in one process: it computes that
rank's slice and refuses every collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os

import torch
import torch.distributed as dist

from raytracer_tpu_torch.models.types import resolve_device

RAY_AXIS = "rays"

# seconds a rank waits for the store and for each collective before the
# group raises (init_process_group's `timeout`)
DEFAULT_TIMEOUT_S = 120.0

# any of these in the environment means an env:// bring-up is configured
_ENV_KEYS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")

log = logging.getLogger(__name__)


def initialize_distributed(backend: str | None = None,
                           init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           timeout: float = DEFAULT_TIMEOUT_S,
                           device=None, local_rank: int | None = None,
                           **kwargs) -> bool:
    """Multi-process bring-up (`torch.distributed.init_process_group`).

    Returns True when the process group is live after the call (started
    now or already running), False for an explicit single-process run
    (no init_method, store, world_size or rank, and none of MASTER_ADDR,
    RANK, WORLD_SIZE in the environment).  A real bring-up failure (a
    rank outside the world, a store that cannot be reached within
    `timeout` seconds) RAISES, so a multi-process launch never degrades
    into N independent single-process renders (mesh.py:23-49).

    The backend follows the device: "nccl" for CUDA (after
    `torch.cuda.set_device(local_rank)`; `local_rank` defaults to
    LOCAL_RANK, else the rank modulo the card count), "gloo" for the
    CPU.  `device` follows the port's rule (CUDA unless asked)."""
    if dist.is_initialized():
        log.info("torch.distributed already initialized")
        return True
    if (init_method is None and kwargs.get("store") is None
            and world_size is None and rank is None
            and not any(k in os.environ for k in _ENV_KEYS)):
        log.info("single-process run (no process group configured)")
        return False
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if (world_size is not None and rank is not None
            and not 0 <= rank < world_size):
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        if local_rank is None:
            local_rank = int(os.environ.get(
                "LOCAL_RANK", (rank or 0) % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout), **kwargs)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ray batches: `size` ranks, this process's `rank`,
    its `device`, and the process group the collectives run over (None:
    a one-rank view with no collective)."""
    size: int
    rank: int
    device: torch.device
    group: object = None

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is outside a mesh of "
                             f"{self.size}")


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The 1-D mesh over every rank of the live process group, or a mesh
    of one rank with no group when there is none."""
    dev = resolve_device(device)
    if dist.is_initialized():
        size = dist.get_world_size()
        if n_devices not in (None, size):
            raise ValueError(f"the process group has {size} ranks, not "
                             f"{n_devices}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh(size, dist.get_rank(), dev, dist.group.WORLD)
    if n_devices not in (None, 1):
        raise ValueError(f"a mesh of {n_devices} ranks needs a process "
                         "group: call initialize_distributed first")
    return Mesh(1, 0, dev)


def ray_sharding(mesh: Mesh, n_rays: int) -> slice:
    """The rows of an (n_rays, ...) ray-sharded array this rank owns."""
    if n_rays % mesh.size:
        raise ValueError(f"{n_rays} rays do not divide over {mesh.size} "
                         "ranks (pad them with pixel_grid)")
    shard = n_rays // mesh.size
    return slice(mesh.rank * shard, (mesh.rank + 1) * shard)


def replicated(mesh: Mesh) -> slice:
    """Every rank holds all of a replicated array."""
    return slice(None)


def _group(mesh: Mesh):
    if mesh.group is None and mesh.size > 1:
        raise ValueError(f"a collective over {mesh.size} ranks needs the "
                         "mesh's process group; this mesh is a one-rank view")
    return mesh.group


def all_gather_rays(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's (r, ...) shard, concatenated in rank order."""
    group = _group(mesh)
    if group is None:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts)


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the ranks in place; returns it."""
    group = _group(mesh)
    if group is not None:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor
