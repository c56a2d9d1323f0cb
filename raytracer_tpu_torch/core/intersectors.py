"""Pluggable acceleration structures for the wavefront pipeline (port of
``raytracer_tpu/core/intersectors.py``).

The reference makes the tracer generic over an `Intersector` trait with
an octree and a brute-force implementation (reference:
raytracer_lib/src/raytracer/accel_intersect.rs:10-13,
oct_tree_intersector.rs, no_acceleration_intersector.rs).  Here an
intersector is an object exposing

    query(scene, origins, dirs, alive, t_limit) -> hit dict
    shadow(scene, origins, dirs, alive, t_min, t_max) -> blocked (R,) bool

- `BruteForceIntersector`: plain-torch scan over all triangles — the
  correctness oracle (no_acceleration_intersector.rs:7-42) and the
  differentiable path.
- `ClusterIntersector` (ops/cuda_cluster.py): Morton-ordered triangle
  clusters, the closest hit in a CUDA kernel.
- `BVHIntersector` (ops/cuda_bvh.py): the packed two-level BVH, the
  closest hit and the fused wavefront levels in CUDA kernels.
"""

from __future__ import annotations

from raytracer_tpu_torch.core.intersect import any_hit_window, closest_hit
from raytracer_tpu_torch.utils.profiling import span


class BruteForceIntersector:
    """Linear scan over all triangles (the reference's
    NoAccelerationIntersector oracle)."""

    name = "brute"

    def __init__(self, chunk: int = 512):
        self.chunk = chunk

    def query(self, scene, origins, dirs, alive=None, t_limit=None):
        """Limited closest hit.  The dense scan ignores `alive` and
        `t_limit` (the limit only culls work; the full closest hit is a
        correct superset) and stays differentiable."""
        return closest_hit(origins, dirs, scene.tri_verts, chunk=self.chunk)

    def closest(self, scene, origins, dirs, alive=None):
        return self.query(scene, origins, dirs)

    def shadow(self, scene, origins, dirs, alive=None, t_min=0.01, t_max=1.0):
        return any_hit_window(origins, dirs, scene.tri_verts, t_min=t_min,
                              t_max=t_max, chunk=self.chunk)


@span("rtx.setup.accel")
def make_intersector(kind: str, scene_buffers=None,
                     triangles_per_leaf: int = 70, **opts):
    """`opts` are forwarded to the accel constructor (e.g. the BVH's
    `seg`/`group`/`ray_block`/`exact_order`, or `device`).  The BVH
    comes back with no shading records installed.  The host build, the
    packing and the upload run in the span `rtx.setup.accel`."""
    if kind == "brute":
        return BruteForceIntersector(**opts)
    if kind == "cluster":
        from raytracer_tpu_torch.ops.cuda_cluster import ClusterIntersector
        return ClusterIntersector(scene_buffers,
                                  triangles_per_leaf=triangles_per_leaf,
                                  **opts)
    if kind == "bvh":
        from raytracer_tpu_torch.ops.cuda_bvh import BVHIntersector
        return BVHIntersector(scene_buffers,
                              triangles_per_leaf=triangles_per_leaf, **opts)
    raise ValueError(f"unknown intersector kind: {kind!r}")
