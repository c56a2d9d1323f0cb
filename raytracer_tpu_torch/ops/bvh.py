"""Host-side construction of the packed two-level BVH (a copy of
``raytracer_tpu/ops/bvh.py``; its arrays must equal the reference's
exactly).

The TPU-native successor of the reference octree build
(reference: raytracer_lib/src/raytracer/accel_intersect/
oct_tree_intersector.rs:66-146).  Differences, all deliberate:

- The reference splits space (octants) and duplicates straddling
  triangles into multiple leaves, then needs the hit-in-cube rejection
  quirk (oct_tree_intersector.rs:160-169).  We split the *triangle set*
  (recursive median split on the longest centroid axis), so every
  triangle lives in exactly one slot and results match brute force
  exactly.
- The output is flat SoA, not pointers, and rows are PACKED FULL: the
  spatial split orders the triangles (DFS), the ordered list is chopped
  into rows of exactly C lanes, and split points are kept aligned to the
  segment size so each of the S consecutive LC-triangle segments of a
  row is a spatially tight chunk.  A naive median split to <=C leaves
  ~61% lane utilization on thai2 (20,049 tris -> 256 half-empty leaves);
  packing makes every Möller–Trumbore lane test a real triangle.
- Culling happens at three granularities: supercluster AABBs (G rows
  each) gate whole ray blocks, per-segment AABBs (S per row, tight
  LC-triangle chunks) both order the rows front-to-back and gate each
  row — min-over-segments is the entry into the row's AABB *union*,
  strictly tighter than one fat row box.

`triangles_per_leaf` is the reference's tunable leaf size
(lib.rs:15-27, main.rs:36-41), here the row width rounded up to the TPU
lane width.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32


@dataclass
class BVH2:
    """Packed two-level flat BVH (host arrays).

    num_superclusters K1, group G rows each, row capacity C lanes,
    seg S segments per row (LC = C // S triangles per segment).
      perm       (K1*G*C,) int32 — packed slot -> original triangle
                                   index (padding slots = -1)
      v0,e1,e2   (K1*G, C, 3)    — triangle origin + edges, packed FULL
                                   in spatial order; padding rows
                                   all-zero (degenerate)
      leaf_aabb  (K1*G, 8) f32   — per-row union [min xyz, max xyz, 0,0]
                                   (XLA-fallback culling); empty rows
                                   get an inverted box (+BIG/-BIG)
      seg_aabb   (K1*G*S, 8) f32 — per-segment AABB (kernel gating);
                                   empty segments inverted
      sc_aabb    (K1, 8) f32     — per-supercluster union box
      orders     (6, K1) int32   — supercluster visit order by centroid
                                   along +x,-x,+y,-y,+z,-z (approximate
                                   front-to-back, the TPU analogue of the
                                   octree's ordered descent,
                                   oct_tree_intersector.rs:176-185)
    """
    leaf_size: int
    group: int
    seg: int
    num_superclusters: int
    num_leaves: int
    num_triangles: int
    perm: np.ndarray
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    leaf_aabb: np.ndarray
    seg_aabb: np.ndarray
    sc_aabb: np.ndarray
    orders: np.ndarray


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _spatial_order(centroids: np.ndarray, chunk: int) -> np.ndarray:
    """Spatially coherent triangle permutation: recursive median split on
    the longest centroid axis with split points aligned to `chunk`, DFS
    order.  Every consecutive `chunk`-sized run of the result is a
    spatially tight set (the packed analogue of octree leaves)."""
    out: list[np.ndarray] = []
    stack = [np.arange(len(centroids), dtype=np.int64)]
    # iterative DFS to dodge Python recursion limits on big scenes
    while stack:
        idx = stack.pop()
        if len(idx) <= chunk:
            out.append(idx)
            continue
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # chunk-aligned median: both sides stay nonempty (chunk <= half
        # < len for len > chunk)
        half = chunk * max(1, int(round(len(idx) / (2.0 * chunk))))
        if half >= len(idx):
            half = len(idx) - chunk
        part = np.argpartition(c[:, axis], half)
        # push right first so left pops first -> DFS order
        stack.append(idx[part[half:]])
        stack.append(idx[part[:half]])
    return np.concatenate(out)


def build_bvh2(tri_verts: np.ndarray, triangles_per_leaf: int = 128,
               group: int = 8, lane: int = 128, seg: int = 4) -> BVH2:
    """tri_verts: (N, 3, 3) float32 world-space triangles."""
    tri_verts = np.asarray(tri_verts, dtype=F)
    N = len(tri_verts)
    C = max(lane, _round_up(max(triangles_per_leaf, 1), lane))
    G = group
    S = seg
    assert C % S == 0, (C, S)
    LC = C // S
    BIG = F(1e30)

    def _empty(K1, NL):
        leaf_aabb = np.zeros((NL, 8), F)
        leaf_aabb[:, 0:3] = BIG
        leaf_aabb[:, 3:6] = -BIG
        seg_aabb = np.zeros((NL * S, 8), F)
        seg_aabb[:, 0:3] = BIG
        seg_aabb[:, 3:6] = -BIG
        sc_aabb = np.zeros((K1, 8), F)
        sc_aabb[:, 0:3] = BIG
        sc_aabb[:, 3:6] = -BIG
        return leaf_aabb, seg_aabb, sc_aabb

    if N == 0:
        K1, NL = 1, G
        leaf_aabb, seg_aabb, sc_aabb = _empty(K1, NL)
        return BVH2(
            leaf_size=C, group=G, seg=S, num_superclusters=K1, num_leaves=NL,
            num_triangles=0, perm=np.full((NL * C,), -1, np.int32),
            v0=np.zeros((NL, C, 3), F), e1=np.zeros((NL, C, 3), F),
            e2=np.zeros((NL, C, 3), F), leaf_aabb=leaf_aabb,
            seg_aabb=seg_aabb, sc_aabb=sc_aabb,
            orders=np.zeros((6, K1), np.int32))

    centroids = tri_verts.mean(axis=1)
    order = _spatial_order(centroids, LC)

    n_rows = -(-N // C)
    NL = _round_up(n_rows, G)
    K1 = NL // G

    perm = np.full((NL * C,), -1, np.int32)
    perm[:N] = order
    v0 = np.zeros((NL, C, 3), F)
    e1 = np.zeros((NL, C, 3), F)
    e2 = np.zeros((NL, C, 3), F)
    tv = tri_verts[order]                          # (N, 3, 3) packed order
    v0.reshape(NL * C, 3)[:N] = tv[:, 0]
    e1.reshape(NL * C, 3)[:N] = tv[:, 1] - tv[:, 0]
    e2.reshape(NL * C, 3)[:N] = tv[:, 2] - tv[:, 0]

    leaf_aabb, seg_aabb, sc_aabb = _empty(K1, NL)
    # per-segment AABBs over the packed order (vectorized: pad vertex
    # mins/maxes to NL*C and reduce per LC chunk)
    vmin = np.full((NL * C, 3), BIG, F)
    vmax = np.full((NL * C, 3), -BIG, F)
    vmin[:N] = tv.min(axis=1)
    vmax[:N] = tv.max(axis=1)
    seg_aabb[:, 0:3] = vmin.reshape(NL * S, LC, 3).min(axis=1)
    seg_aabb[:, 3:6] = vmax.reshape(NL * S, LC, 3).max(axis=1)
    leaf_aabb[:, 0:3] = seg_aabb[:, 0:3].reshape(NL, S, 3).min(axis=1)
    leaf_aabb[:, 3:6] = seg_aabb[:, 3:6].reshape(NL, S, 3).max(axis=1)
    sc_aabb[:, 0:3] = leaf_aabb[:, 0:3].reshape(K1, G, 3).min(axis=1)
    sc_aabb[:, 3:6] = leaf_aabb[:, 3:6].reshape(K1, G, 3).max(axis=1)

    centers = 0.5 * (sc_aabb[:, 0:3] + sc_aabb[:, 3:6])
    orders = np.zeros((6, K1), np.int32)
    for axis in range(3):
        fwd = np.argsort(centers[:, axis], kind="stable").astype(np.int32)
        orders[2 * axis] = fwd
        orders[2 * axis + 1] = fwd[::-1]

    return BVH2(
        leaf_size=C, group=G, seg=S, num_superclusters=K1, num_leaves=NL,
        num_triangles=N, perm=perm, v0=v0, e1=e1, e2=e2,
        leaf_aabb=leaf_aabb, seg_aabb=seg_aabb, sc_aabb=sc_aabb,
        orders=orders)
