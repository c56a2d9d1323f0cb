"""Host-side cluster-grid builder (a copy of ``raytracer_tpu/ops/cluster.py``;
its arrays must equal the reference's exactly).

Replaces the reference octree build (reference:
oct_tree_intersector.rs:66-146: recursive split with SAT triangle-box
tests) with a flat, branchless layout:

1. compute scene extents (the reference's calc_extents,
   oct_tree_intersector.rs:315-330),
2. Morton-sort triangles by quantized centroid so spatially nearby
   triangles share clusters,
3. chop the sorted order into fixed-size clusters (size = the
   `triangles_per_leaf` knob, rounded up to a lane multiple of 128 — the
   same tunable the reference exposes, lib.rs:15-27 / main.rs:36-41),
4. record per-cluster AABBs for slab culling.

Every triangle lives in exactly one cluster (no duplication, no
hit-in-cube rejection quirk), so results match brute force exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32


def _expand_bits(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd position (standard Morton interleave)."""
    x = x.astype(np.uint64)
    x = (x | (x << 16)) & np.uint64(0x030000FF)
    x = (x | (x << 8)) & np.uint64(0x0300F00F)
    x = (x | (x << 4)) & np.uint64(0x030C30C3)
    x = (x | (x << 2)) & np.uint64(0x09249249)
    return x


def morton_codes(points: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points quantized into [lo, hi]."""
    extent = np.maximum(hi - lo, 1e-30)
    q = np.clip(((points - lo) / extent) * 1024.0, 0, 1023).astype(np.uint32)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | _expand_bits(q[:, 2])


@dataclass
class ClusterGrid:
    """Flat cluster acceleration structure (host arrays).

    num_clusters K, cluster_size C; padded triangle count K*C.
      perm      (K*C,) int32  — sorted position -> original triangle index
                               (padding slots = -1)
      v0, e1, e2 (K, C, 3)    — triangle origin + edge vectors, sorted;
                               padding rows are all-zero (degenerate, can
                               never pass the |det| >= eps test)
      aabb_min/max (K, 3)     — per-cluster bounds
      orders    (6, K) int32  — cluster visit order sorted by centroid
                               along +x,-x,+y,-y,+z,-z: the walk picks the
                               order matching a ray's dominant direction
                               for approximate front-to-back visiting
                               (oct_tree_intersector.rs:176-185)
    """
    cluster_size: int
    num_clusters: int
    num_triangles: int
    perm: np.ndarray
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    orders: np.ndarray


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_cluster_grid(tri_verts: np.ndarray, triangles_per_leaf: int = 70,
                       lane: int = 128) -> ClusterGrid:
    """tri_verts: (N, 3, 3) float32 world-space triangles."""
    tri_verts = np.asarray(tri_verts, dtype=F)
    N = len(tri_verts)
    C = max(lane, round_up(max(triangles_per_leaf, 1), lane))

    if N == 0:
        K = 1
        return ClusterGrid(
            cluster_size=C, num_clusters=K, num_triangles=0,
            perm=np.full((K * C,), -1, np.int32),
            v0=np.zeros((K, C, 3), F), e1=np.zeros((K, C, 3), F),
            e2=np.zeros((K, C, 3), F),
            aabb_min=np.zeros((K, 3), F), aabb_max=np.zeros((K, 3), F),
            orders=np.zeros((6, K), np.int32),
        )

    from raytracer_tpu_torch import native
    order = native.morton_order(tri_verts).astype(np.int64)

    K = round_up(N, C) // C
    pad = K * C - N
    perm = np.concatenate([order, np.full((pad,), -1, np.int64)]).astype(np.int32)

    sorted_tris = np.zeros((K * C, 3, 3), dtype=F)
    sorted_tris[:N] = tri_verts[order]
    v0 = sorted_tris[:, 0].reshape(K, C, 3)
    e1 = (sorted_tris[:, 1] - sorted_tris[:, 0]).reshape(K, C, 3)
    e2 = (sorted_tris[:, 2] - sorted_tris[:, 0]).reshape(K, C, 3)

    tri_min = sorted_tris.min(axis=1).reshape(K, C, 3)
    tri_max = sorted_tris.max(axis=1).reshape(K, C, 3)
    valid = (perm >= 0).reshape(K, C, 1)
    aabb_min = np.where(valid, tri_min, np.inf).min(axis=1).astype(F)
    aabb_max = np.where(valid, tri_max, -np.inf).max(axis=1).astype(F)
    # all-padding clusters (can't happen with K derived from N, but guard)
    empty = ~valid.any(axis=1)[:, 0]
    aabb_min[empty] = 0.0
    aabb_max[empty] = 0.0

    centers = 0.5 * (aabb_min + aabb_max)          # (K, 3)
    orders = np.zeros((6, K), np.int32)
    for axis in range(3):
        fwd = np.argsort(centers[:, axis], kind="stable").astype(np.int32)
        orders[2 * axis] = fwd          # rays travelling +axis: near first
        orders[2 * axis + 1] = fwd[::-1]

    return ClusterGrid(
        cluster_size=C, num_clusters=K, num_triangles=N,
        perm=perm, v0=v0, e1=e1, e2=e2,
        aabb_min=aabb_min, aabb_max=aabb_max, orders=orders,
    )
