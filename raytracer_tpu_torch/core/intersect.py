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


def _tri_planes(tv):
    """v0, e1 = v1 - v0, e2 = v2 - v0 of triangles tv (..., 3, 3), as
    nine component tensors."""
    v0 = tv[..., 0, :]
    e1 = tv[..., 1, :] - v0
    e2 = tv[..., 2, :] - v0
    return [a[..., k] for a in (v0, e1, e2) for k in range(3)]


def _select(origins, dirs, tri_verts, chunk, ray_chunk):
    """The closest-hit scan: t, u, v and the winning triangle index
    (int64, 0 on a miss) of every ray, triangle chunk by triangle chunk
    within ray chunks of `ray_chunk` rays."""
    R = origins.shape[0]
    dev = origins.device
    best_t = torch.full((R,), BIG_T, dtype=torch.float32, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_i = torch.zeros((R,), dtype=torch.int64, device=dev)
    tris = [[p[None, :] for p in _tri_planes(tri_verts[s:s + chunk])]
            for s in range(0, tri_verts.shape[0], chunk)]
    for r in range(0, R, ray_chunk):
        rows = slice(r, r + ray_chunk)
        ray = [c[rows, None] for c in (*origins.unbind(1), *dirs.unbind(1))]
        bt, bu, bv, bi = (best_t[rows], best_u[rows], best_v[rows],
                          best_i[rows])
        for ci, tri in enumerate(tris):
            t, u, v = moller_trumbore(*ray, *tri)
            # per-chunk argmin; ties -> lowest index (first minimum)
            j = t.argmin(dim=1, keepdim=True)
            tj = t.gather(1, j)[:, 0]
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bu = torch.where(better, u.gather(1, j)[:, 0], bu)
            bv = torch.where(better, v.gather(1, j)[:, 0], bv)
            bi = torch.where(better, j[:, 0] + ci * chunk, bi)
        best_t[rows], best_u[rows], best_v[rows], best_i[rows] = bt, bu, bv, bi
    return best_t, best_u, best_v, best_i


def closest_hit(origins, dirs, tri_verts, chunk: int = 512,
                ray_chunk: int = 16384):
    """Closest-hit query of R rays against all N triangles.

    origins/dirs (R, 3); tri_verts (N, 3, 3).  Returns a dict with t (R,),
    u (R,), v (R,), tri (R,) int32 (closest triangle index, 0 when no
    hit), hit (R,) bool.  The scan runs over chunks of `chunk` triangles
    within chunks of `ray_chunk` rays, so its (rays x triangles)
    temporaries stay bounded at any R.

    The selection runs without autograd.  When an input requires grad,
    t, u and v are computed again for each ray's winning triangle alone,
    from the live tensors by the same `moller_trumbore`, so they carry
    the gradient of the winner (as the JAX scan's gather of the winning
    lane does, intersect.py:84-92) and equal the selected values bit for
    bit.  Autograd then holds (R,) residuals, not (R, chunk) ones."""
    with torch.no_grad():
        t, u, v, idx = _select(origins, dirs, tri_verts, chunk, ray_chunk)
    hit = t < BIG_T
    if torch.is_grad_enabled() and (origins.requires_grad
                                    or dirs.requires_grad
                                    or tri_verts.requires_grad):
        tw, uw, vw = moller_trumbore(*origins.unbind(1), *dirs.unbind(1),
                                     *_tri_planes(tri_verts[idx]))
        t, u, v = (torch.where(hit, w, x) for w, x in ((tw, t), (uw, u),
                                                       (vw, v)))
    tri_idx = torch.where(hit, idx, torch.zeros_like(idx))
    return dict(t=t, u=u, v=v, tri=tri_idx.to(torch.int32), hit=hit)


class _Carry(torch.autograd.Function):
    """`value` forward (bit for bit); the gradient goes to `carrier`."""

    @staticmethod
    def forward(ctx, value, carrier):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def winner_grad(origins, dirs, tri, res):
    """Gradients to the rays through a kernel intersector's closest hit.

    `res` is the hit dict of a selection made without autograd (t, u, v,
    hit, and slot: each hit ray's winning column of `tri`, 0 on a miss);
    `tri` (9, NS) is the intersector's own plane copy of its triangles
    [v0, e1, e2] x [x, y, z].  When grad mode is on and the rays require
    grad, t, u and v of every hit ray are computed again by
    `moller_trumbore` on its winning slot's planes; the values stay the
    selection's bit for bit and the gradient is the recompute's.  As on
    the JAX package's XLA path (`xla_cluster_closest`, the winning lane
    of a scan over the intersector's copy), the gradient reaches the
    rays only, never the scene's vertices.  Missed and dead rays are
    recomputed as a safe ray (origin 0, direction (1, 1, 1), slot 0), so
    that their gradient is a finite one that the `where` stops, not
    0 * inf."""
    if not (torch.is_grad_enabled()
            and (origins.requires_grad or dirs.requires_grad)):
        return res
    hit = res["hit"]
    o = torch.where(hit[:, None], origins, torch.zeros_like(origins))
    d = torch.where(hit[:, None], dirs, torch.ones_like(dirs))
    tw, uw, vw = moller_trumbore(*o.unbind(1), *d.unbind(1),
                                 *tri[:, res["slot"].long()].unbind(0))
    out = dict(res)
    for k, w in (("t", tw), ("u", uw), ("v", vw)):
        out[k] = _Carry.apply(res[k], w)
    return out


def any_hit_window(origins, dirs, tri_verts, t_min=0.01, t_max=1.0,
                   chunk: int = 512):
    """Occlusion query with the reference's shadow semantics
    (raytracer/mod.rs:224-230): the CLOSEST hit, window-checked strictly
    on both ends, t along the unnormalized direction.  A closer occluder
    outside the window (t <= t_min) therefore unblocks the light even
    if a farther one lies inside it.  Returns blocked (R,) bool (no
    gradient: the decision is discrete)."""
    with torch.no_grad():
        res = closest_hit(origins, dirs, tri_verts, chunk=chunk)
    return res["hit"] & (res["t"] > t_min) & (res["t"] < t_max)
