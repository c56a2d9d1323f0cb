"""Host-side octree mirroring the reference accelerator's semantics
(the port's own copy of ``raytracer_tpu/compat/octree.py``: numpy only).

The production paths use the BVH (ops/bvh.py) and the cluster grid
(ops/cluster.py), whose results match brute force exactly.  The
reference octree (reference: raytracer_lib/src/raytracer/accel_intersect/
oct_tree_intersector.rs) has a quirk the cluster grid does not
reproduce: triangles may span multiple leaves, and a leaf's closest hit
is REJECTED unless the hit point lies inside that leaf's cube
(oct_tree_intersector.rs:160-169), which near cube boundaries can
differ from brute force.  This module is a faithful numpy mirror of
that structure — build (SAT triangle-box insertion, split while a leaf
exceeds `triangles_per_leaf`, max depth 8) and ordered traversal — used
to quantify exactly when/where the reference's answers would deviate.

Scalar per-ray; intended for tests and parity studies only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_TRIANGLES_PER_LEAF = 70  # oct_tree_intersector.rs:12
MAX_DEPTH = 8                    # oct_tree_intersector.rs:108

F = np.float32


@dataclass
class _Node:
    # leaf: triangle index list; inner: 8 child node indices
    tri_indices: Optional[np.ndarray] = None
    children: Optional[List[int]] = None


class OctTreeIntersector:
    """Parallel nodes/cubes arrays — node idx == its cube idx, the
    invariant exploited at oct_tree_intersector.rs:165."""

    def __init__(self, tri_verts: np.ndarray,
                 triangles_per_leaf: int = DEFAULT_TRIANGLES_PER_LEAF):
        self.tris = np.asarray(tri_verts, dtype=F)        # (N, 3, 3)
        lo = self.tris.reshape(-1, 3).min(axis=0) if len(self.tris) else np.zeros(3, F)
        hi = self.tris.reshape(-1, 3).max(axis=0) if len(self.tris) else np.zeros(3, F)
        self.cubes: List[Tuple[np.ndarray, np.ndarray]] = [(lo, hi)]
        self.nodes: List[_Node] = [_Node(tri_indices=np.arange(len(self.tris)))]
        self._split(0, triangles_per_leaf, 0)

    # -- build (oct_tree_intersector.rs:94-146) --------------------------

    def _split(self, node_idx: int, n_max: int, depth: int):
        node = self.nodes[node_idx]
        if node.tri_indices is None or len(node.tri_indices) <= n_max \
                or depth > MAX_DEPTH:
            return
        lo, hi = self.cubes[node_idx]
        mid = 0.5 * (lo + hi)
        children = []
        child_nodes = []
        # child cube order of oct_tree_intersector.rs:275-313
        octants = [
            (lo, mid),
            (np.array([mid[0], lo[1], lo[2]]), np.array([hi[0], mid[1], mid[2]])),
            (np.array([lo[0], mid[1], lo[2]]), np.array([mid[0], hi[1], mid[2]])),
            (np.array([mid[0], mid[1], lo[2]]), np.array([hi[0], hi[1], mid[2]])),
            (np.array([lo[0], lo[1], mid[2]]), np.array([mid[0], mid[1], hi[2]])),
            (np.array([mid[0], lo[1], mid[2]]), np.array([hi[0], mid[1], hi[2]])),
            (np.array([lo[0], mid[1], mid[2]]), np.array([mid[0], hi[1], hi[2]])),
            (mid, hi),
        ]
        for clo, chi in octants:
            inside = np.array(
                [ti for ti in node.tri_indices
                 if _triangle_cube_intersection(clo.astype(F), chi.astype(F),
                                                self.tris[ti])],
                dtype=np.int64)
            self.cubes.append((clo.astype(F), chi.astype(F)))
            child_idx = len(self.cubes) - 1
            child_nodes.append(_Node(tri_indices=inside))
            children.append(child_idx)
        self.nodes[node_idx] = _Node(children=children)
        start = len(self.nodes)
        self.nodes.extend(child_nodes)
        assert start == children[0]  # parallel-array invariant
        for child_idx in children:
            self._split(child_idx, n_max, depth + 1)

    # -- traversal (oct_tree_intersector.rs:148-246) ---------------------

    def intersect_ray(self, o: np.ndarray, d: np.ndarray):
        """Returns (t, u, v, tri_idx) or None, with the reference's
        hit-in-cube rejection and front-to-back child ordering."""
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_d = 1.0 / d
        return self._intersect_node(o, d, inv_d, 0)

    def _intersect_node(self, o, d, inv_d, node_idx):
        node = self.nodes[node_idx]
        if node.tri_indices is not None:  # leaf
            hit = self._closest_in_leaf(o, d, node.tri_indices)
            if hit is None:
                return None
            hp = o + hit[0] * d
            lo, hi = self.cubes[node_idx]
            # hit point must lie inside THIS cube
            # (oct_tree_intersector.rs:160-169)
            if np.all(hp >= lo) and np.all(hp <= hi):
                return hit
            return None
        # inner: slab-test children, sort by entry t, first hit wins
        dists = []
        for ci in node.children:
            t = _intersect_cube_inverse_ray(o, inv_d, *self.cubes[ci])
            if t is not None:
                dists.append((t, ci))
        dists.sort(key=lambda x: x[0])
        for _, ci in dists:
            hit = self._intersect_node(o, d, inv_d, ci)
            if hit is not None:
                return hit
        return None

    def _closest_in_leaf(self, o, d, tri_indices):
        best = None
        for ti in tri_indices:
            tri = self.tris[ti]
            res = mt_intersect_scalar(o, d, tri[0], tri[1], tri[2])
            if res is not None and (best is None or res[0] < best[0]):
                best = (res[0], res[1], res[2], int(ti))
        return best


F32_EPS = np.float32(1.1920929e-07)


def mt_intersect_scalar(o, d, v0, v1, v2):
    """Scalar Möller–Trumbore with the reference accept criteria
    (intersect.rs:62-98)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(d, e2)
    det = float(e1 @ pvec)
    if abs(det) < F32_EPS:
        return None
    inv_det = 1.0 / det
    tvec = o - v0
    u = float(tvec @ pvec) * inv_det
    qvec = np.cross(tvec, e1)
    v = float(d @ qvec) * inv_det
    t = float(e2 @ qvec) * inv_det
    if u < 0.0 or u > 1.0 or v < 0.0 or u + v > 1.0 or t < 0.0:
        return None
    return t, u, v


def _intersect_cube_inverse_ray(o, inv_d, lo, hi):
    """Slab test; negative t when origin inside
    (oct_tree_intersector.rs:348-372)."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = np.minimum(t1, t2).max()
    tmax = np.maximum(t1, t2).min()
    if tmax >= tmin and tmax > 0.0:
        return float(tmin)
    return None


def _project(points, axis):
    vals = points @ axis
    return vals.min(), vals.max()


def _triangle_cube_intersection(lo, hi, tri):
    """SAT triangle-box test (oct_tree_intersector.rs:393-458)."""
    # cube-axis tests
    for c in range(3):
        if tri[:, c].max() < lo[c] or tri[:, c].min() > hi[c]:
            return False
    cube_verts = np.array([
        lo,
        [hi[0], lo[1], lo[2]],
        [lo[0], hi[1], lo[2]],
        [lo[0], lo[1], hi[2]],
        [lo[0], hi[1], hi[2]],
        [hi[0], lo[1], hi[2]],
        [hi[0], hi[1], lo[2]],
        hi,
    ], dtype=F)
    e1 = tri[0] - tri[1]
    e2 = tri[1] - tri[2]
    n = np.cross(e1, e2)
    offset = float(n @ tri[0])
    cmin, cmax = _project(cube_verts, n)
    if cmax < offset or cmin > offset:
        return False
    e3 = tri[2] - tri[0]
    axes = [np.cross(e, ax) for e in (e1, e2, e3)
            for ax in np.eye(3, dtype=F)]
    for axis in axes:
        cmin, cmax = _project(cube_verts, axis)
        tmin, tmax = _project(tri, axis)
        if cmax < tmin or cmin > tmax:
            return False
    return True
