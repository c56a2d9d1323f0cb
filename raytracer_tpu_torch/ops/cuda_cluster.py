"""Flat Morton-cluster grid on the GPU: the closest-hit kernel, its plain
PyTorch version, and the intersector of accel="cluster" (PyTorch port
of ``raytracer_tpu/ops/pallas_intersect.py``).

One CUDA kernel (``csrc/cuda_cluster.cu``) replaces the TPU kernel:

- `cluster_closest` <- `pallas_cluster_closest` (pallas_intersect.py:312):
  t, u, v and the packed slot of every ray's closest hit, exact below a
  runtime t limit.

What bounds it on an H100 and what the design does about it is noted
at the top of the CUDA source: the warp walk of `bvh_closest`, written
for the flat grid (`walk_takes` there refuses the shapes it does not
take).  The
wrapper checks its operands' shapes on any device, then runs the plain
version for tensors on the CPU only; for CUDA tensors it launches the
kernel or raises.  It keeps a launch count (`cluster_closest.launches`)
that only a kernel launch raises.  `cluster_tests_needed` runs the
per-ray walk of the first version on the card as a counting entry (the
yardstick of the kernel's bound; no plain version, no launch count).
Built with nvcc for sm_90a on first use into ``build/torch_kernels/``
and bound through ctypes (ops/cuda_build.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from raytracer_tpu_torch.core.intersect import BIG_T, winner_grad
from raytracer_tpu_torch.models.types import resolve_device
from raytracer_tpu_torch.ops import cuda_build
from raytracer_tpu_torch.ops.cluster import build_cluster_grid
from raytracer_tpu_torch.ops.cuda_build import (Fl, I, L, P, check_cuda,
                                                counted, cuda_stream, event,
                                                ptr, raise_on)
from raytracer_tpu_torch.ops.cuda_bvh import (DEFAULT_RAY_BLOCK,
                                              SHADOW_T_MAX, SHADOW_T_MIN,
                                              closest_plain, hit_dict,
                                              rays_from)

# what an invalid-value error of the cluster kernel means
WALK_SHAPES = ("a shape the walk does not take "
               "(csrc/cuda_cluster.cu walk_takes)")


def _setup(lib):
    lib.rtx_cluster_closest.restype = I
    lib.rtx_cluster_closest.argtypes = [
        P, L, P, P, P, L, I, I, Fl, P, P, P, P, I, P]
    lib.rtx_cluster_tests_needed.restype = I
    lib.rtx_cluster_tests_needed.argtypes = [
        P, L, P, P, P, L, I, I, Fl, P, P, P, I, P]


def _load():
    """The bound library (csrc/cuda_cluster.cu), built first if missing
    or older than its source."""
    return cuda_build.load("cuda_cluster", _setup)


@dataclass
class PackedGrid:
    """The cluster grid as the kernel reads it, on one device.

    tri (9, K*C) f32 — v0 xyz, e1 xyz, e2 xyz planes over packed slots;
    aabb (K, 8) f32 [min xyz, max xyz, 0, 0]; orders (6, K) int32
    """
    tri: torch.Tensor
    aabb: torch.Tensor
    orders: torch.Tensor
    C: int

    @property
    def num_slots(self) -> int:
        return self.tri.shape[1]

    @property
    def num_clusters(self) -> int:
        return self.aabb.shape[0]


def nan_culled(rays, grid: PackedGrid):
    """(n, K*C) bool: the slots of every cluster whose slab test gives
    NaN for the ray, which the kernel culls.  A zero direction component
    inverts to inf (raw 1/d, pallas_intersect.py:198), and an origin on
    that box plane then gives 0 * inf = NaN."""
    lo, hi = grid.aabb[:, 0:3], grid.aabb[:, 3:6]
    nan = torch.zeros((rays.shape[1], grid.num_clusters), dtype=torch.bool,
                      device=rays.device)
    for c in range(3):
        o, inv = rays[c][:, None], (1.0 / rays[3 + c])[:, None]
        nan |= ((lo[None, :, c] - o) * inv).isnan()
        nan |= ((hi[None, :, c] - o) * inv).isnan()
    return nan.repeat_interleave(grid.C, dim=1)


def cluster_closest_plain(rays, grid: PackedGrid):
    """Plain PyTorch version of the cluster kernel (see
    `cluster_closest`): the dense closest hit over the clusters that the
    ray's slab tests do not turn to NaN; exact at any limit."""
    t, slot, uu, vv = closest_plain(rays, grid.tri,
                                    cull=lambda r: nan_culled(r, grid))
    return dict(t=t, u=uu, v=vv, slot=slot.to(torch.int32))


def cluster_closest(rays, grid: PackedGrid, *, t_limit=None,
                    ray_block: int = DEFAULT_RAY_BLOCK, tests_out=None):
    """Closest hit of every ray over the cluster grid (replaces
    pallas_cluster_closest, raytracer_tpu/ops/pallas_intersect.py:312).

    rays (6, R) f32 (dead rays: |ox| >= 1e30); t_limit: the closest hit
    below it is exact, beyond it clusters may be culled.  tests_out:
    optional (R,) int32 that receives, per ray, the number of
    ray-triangle tests its warp ran (kernel only).

    Returns a dict: t (R,) [BIG_T on a miss], u, v (R,) [0 on a miss],
    slot (R,) int32 packed slot [-1 on a miss]."""
    if rays.shape[0] != 6:
        raise ValueError(f"cluster_closest: rays {tuple(rays.shape)}")
    if rays.device.type == "cpu":
        return cluster_closest_plain(rays, grid)
    check_cuda("cluster_closest", rays, grid.tri, grid.aabb, grid.orders,
               tests_out)
    R = rays.shape[1]
    dev = rays.device
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    uv = torch.empty((2, R), dtype=torch.float32, device=dev)
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    limit = BIG_T if t_limit is None else float(t_limit)
    lib = _load()
    start = event(cluster_closest)
    code = lib.rtx_cluster_closest(
        ptr(rays), R, ptr(grid.tri), ptr(grid.aabb), ptr(grid.orders),
        grid.num_slots, grid.C, grid.num_clusters, limit, ptr(t), ptr(uv),
        ptr(slot), ptr(tests_out), ray_block, cuda_stream(dev))
    raise_on(code, "cluster_closest", WALK_SHAPES)
    counted(cluster_closest, start, R)
    return dict(t=t, u=uv[0], v=uv[1], slot=slot)


cluster_closest.launches = 0
cluster_closest.events = None     # a list: (start, end, rays) of each launch


def cluster_tests_needed(rays, grid: PackedGrid, *, t_limit=None):
    """The clusters each ray enters before its best t in the per-ray
    walk (one thread a ray, in its own direction order); times C, the
    tests the ray needs: the yardstick of the kernel's bound, on the same
    rays at the same t limit.  Kernel only (it raises on a CPU tensor)
    and never timed.

    Returns a dict of (R,) tensors: clusters (int32), and the walk's own
    closest hit t and slot (int32, -1 on a miss)."""
    if rays.shape[0] != 6:
        raise ValueError(f"cluster_tests_needed: rays {tuple(rays.shape)}")
    check_cuda("cluster_tests_needed", rays, grid.tri, grid.aabb,
               grid.orders)
    R = rays.shape[1]
    dev = rays.device
    clusters, slot = (torch.empty((R,), dtype=torch.int32, device=dev)
                      for _ in range(2))
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    code = _load().rtx_cluster_tests_needed(
        ptr(rays), R, ptr(grid.tri), ptr(grid.aabb), ptr(grid.orders),
        grid.num_slots, grid.C, grid.num_clusters,
        BIG_T if t_limit is None else float(t_limit), ptr(clusters), ptr(t),
        ptr(slot), DEFAULT_RAY_BLOCK, cuda_stream(dev))
    raise_on(code, "cluster_tests_needed")
    return dict(clusters=clusters, t=t, slot=slot)


class ClusterIntersector:
    """The flat cluster grid on one device (accel="cluster").  The
    `triangles_per_leaf` knob is the reference's octree leaf size
    (lib.rs:15-27), here the cluster size rounded to a multiple of 128
    lanes.

    `query` is differentiable to the rays as the JAX package's XLA path
    is (`cuda_bvh.BVHIntersector`): the kernel selects without autograd
    and t, u and v of each winner are recomputed from this grid's own
    copy of the triangles (`winner_grad`)."""

    name = "cluster"

    def __init__(self, scene_buffers, triangles_per_leaf: int = 70,
                 ray_block: int = DEFAULT_RAY_BLOCK, device=None):
        grid = build_cluster_grid(np.asarray(scene_buffers.tri_verts),
                                  triangles_per_leaf=triangles_per_leaf)
        self._init(grid.perm, grid.v0, grid.e1, grid.e2, grid.aabb_min,
                   grid.aabb_max, grid.orders, ray_block, device)

    @classmethod
    def from_grid_arrays(cls, perm, v0, e1, e2, aabb_min, aabb_max, orders,
                         ray_block=DEFAULT_RAY_BLOCK, device=None):
        """An intersector over cluster-grid arrays built elsewhere
        (numpy), e.g. by the reference's build_cluster_grid, so the
        kernel can be held against the reference on identical inputs."""
        self = cls.__new__(cls)
        self._init(perm, v0, e1, e2, aabb_min, aabb_max, orders, ray_block,
                   device)
        return self

    def _init(self, perm, v0, e1, e2, aabb_min, aabb_max, orders, ray_block,
              device):
        dev = resolve_device(device)
        v0, e1, e2 = (np.asarray(a, np.float32) for a in (v0, e1, e2))
        K, C, _ = v0.shape
        aabb_min = np.asarray(aabb_min, np.float32)
        aabb_max = np.asarray(aabb_max, np.float32)
        aabb8 = np.zeros((K, 8), np.float32)
        aabb8[:, 0:3] = aabb_min
        aabb8[:, 3:6] = aabb_max
        tri = np.stack([a[:, :, c].reshape(-1) for a in (v0, e1, e2)
                        for c in range(3)])                 # (9, K*C)

        def to(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
        self.device = dev
        self.ray_block = ray_block
        self.packed = PackedGrid(tri=to(tri, np.float32),
                                 aabb=to(aabb8, np.float32),
                                 orders=to(orders, np.int32), C=C)
        self.perm = to(np.maximum(np.asarray(perm), 0), np.int32)
        # world bounds for bounce-ray sort keys, float32 values
        lo = aabb_min.min(axis=0)
        hi = aabb_max.max(axis=0)
        inv = (1.0 / np.maximum(hi - lo, 1e-30)).astype(np.float32)
        self.world_lo = tuple(float(x) for x in lo)
        self.world_inv_span = tuple(float(x) for x in inv)

    def query(self, scene, origins, dirs, alive=None, t_limit=None):
        """Generic closest hit of (R, 3) rays with a t limit (shadow
        queries pass the window maximum); dead rays (alive False) miss.
        Under autograd, t, u and v carry the rays' gradient
        (`winner_grad`)."""
        with torch.no_grad():
            res = cluster_closest(rays_from(origins, dirs, alive),
                                  self.packed, t_limit=t_limit,
                                  ray_block=self.ray_block)
        return winner_grad(origins, dirs, self.packed.tri,
                           hit_dict(res, self.perm))

    def closest(self, scene, origins, dirs, alive=None):
        return self.query(scene, origins, dirs, alive=alive)

    def shadow(self, scene, origins, dirs, alive=None, t_min=SHADOW_T_MIN,
               t_max=SHADOW_T_MAX):
        """Closest-then-window occlusion (mod.rs:224-230).  Culling
        clusters whose entry exceeds t_max cannot change the outcome."""
        with torch.no_grad():
            res = self.query(scene, origins, dirs, alive=alive,
                             t_limit=t_max)
        return res["hit"] & (res["t"] > t_min) & (res["t"] < t_max)
