"""Batched Moller-Trumbore ray-triangle intersection in plain PyTorch
(port of ``raytracer_tpu/core/intersect.py``).

Capability parity with the reference intersection layer
(reference: raytracer_lib/src/raytracer/intersect.rs:62-98,
`intersect_late_out`) and the brute-force intersector it feeds
(no_acceleration_intersector.rs:13-41): one call intersects a whole ray
wavefront against the whole triangle buffer, scanning triangle chunks to
bound memory.

Accept criteria match the reference exactly:
  |det| >= f32::EPSILON  (parallel rejection, intersect.rs:70-75)
  0 <= u <= 1, v >= 0, u + v <= 1, t >= 0  (intersect.rs:88-96)
written as one sign test, min(u, v, 1 - (u + v), t) >= 0: u <= 1 follows
from v >= 0 and u + v <= 1 under round-to-nearest, and 1 - s keeps the
sign of 1 - s exactly (tests/test_torch_intersect.py holds the two forms
equal).  A NaN anywhere rejects, as the chain of comparisons does.
Closest hit = smallest accepted t; ties resolve to the lower triangle
index (the first strict minimum, no_acceleration_intersector.rs:33).

This is the correctness oracle and the arithmetic every plain kernel
version shares (ops/cuda_bvh.py, ops/cuda_cluster.py); it is written in
differentiable torch operations.
"""

from __future__ import annotations

import torch

F32_EPSILON = 1.1920929e-07  # f32::EPSILON, matches intersect.rs:70
BIG_T = 3.0e38  # sentinel "no hit" distance (< f32 max, safe in arithmetic)


def moller_trumbore(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z,
                    e2x, e2y, e2z):
    """Moller-Trumbore on broadcast component tensors, in the operation
    order of the kernels (csrc/*.cu).  Returns t, u, v; t is BIG_T where
    the pair is rejected."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    non_par = det.abs() >= F32_EPSILON
    inv_det = 1.0 / torch.where(non_par, det, torch.ones_like(det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    del px, py, pz, det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    del tvx, tvy, tvz
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    del qx, qy, qz, inv_det
    ok = non_par & (torch.minimum(torch.minimum(uu, vv),
                                  torch.minimum(1.0 - (uu + vv), tt)) >= 0.0)
    return torch.where(ok, tt, torch.full_like(tt, BIG_T)), uu, vv


def closest_hit(origins, dirs, tri_verts, chunk: int = 512):
    """Closest-hit query of R rays against all N triangles.

    origins/dirs (R, 3); tri_verts (N, 3, 3).  Returns a dict with t (R,),
    u (R,), v (R,), tri (R,) int32 (closest triangle index, 0 when no
    hit), hit (R,) bool."""
    R = origins.shape[0]
    dev = origins.device
    best_t = torch.full((R,), BIG_T, dtype=torch.float32, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_i = torch.zeros((R,), dtype=torch.int64, device=dev)
    ray = [c[:, None] for c in torch.cat([origins, dirs], dim=1).unbind(1)]
    for s in range(0, tri_verts.shape[0], chunk):
        tv = tri_verts[s:s + chunk]
        v0 = tv[:, 0]
        e1 = tv[:, 1] - v0
        e2 = tv[:, 2] - v0
        tri = [a[None, :, k] for a in (v0, e1, e2) for k in range(3)]
        t, u, v = moller_trumbore(*ray, *tri)
        # per-chunk argmin; ties -> lowest index (first minimum)
        j = t.argmin(dim=1, keepdim=True)
        tj = t.gather(1, j)[:, 0]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_u = torch.where(better, u.gather(1, j)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, j)[:, 0], best_v)
        best_i = torch.where(better, j[:, 0] + s, best_i)
    hit = best_t < BIG_T
    tri_idx = torch.where(hit, best_i, torch.zeros_like(best_i))
    return dict(t=best_t, u=best_u, v=best_v, tri=tri_idx.to(torch.int32),
                hit=hit)


def any_hit_window(origins, dirs, tri_verts, t_min=0.01, t_max=1.0,
                   chunk: int = 512):
    """Occlusion query with the reference's shadow semantics
    (raytracer/mod.rs:224-230): the CLOSEST hit, window-checked strictly
    on both ends, t along the unnormalized direction.  A closer occluder
    outside the window (t <= t_min) therefore unblocks the light even
    if a farther one lies inside it.  Returns blocked (R,) bool."""
    res = closest_hit(origins, dirs, tri_verts, chunk=chunk)
    return res["hit"] & (res["t"] > t_min) & (res["t"] < t_max)
