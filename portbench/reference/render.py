"""The plain reference renderer: what raytracer-rs computes per pixel
(raytracer/mod.rs:80-261), written out in plain PyTorch over a
brute-force closest hit, independent of the program under test.

- Primary rays: jittered pinhole rays, xfov on both axes, the y
  direction negated, directions unnormalised (camera.rs:80-90).
- Closest hit: Moller-Trumbore against every triangle, accepted when
  |det| >= f32::EPSILON, u >= 0, v >= 0, u + v <= 1, t >= 0
  (intersect.rs:62-98); the smallest t wins, ties to the lower index.
- Shading: geometric normal, never flipped; per light, skipped unless
  dot(n, l) >= 0; a shadow ray from hit + 0.01 * to_light along
  to_light is blocked iff its closest hit lies in (0.01, 1); Phong
  diffuse (flat colour or the nearest texel at the barycentric u, v,
  clamped) times dot(n, l) plus white specular dot(view, reflect)^32,
  times the light colour (mod.rs:198-261).
- Bounces: two levels; a hit spawns 2 children at level 0 and 1 at
  level 1 along a Gaussian draw normalised and flipped into the
  normal's hemisphere, from hit + 1e-5 * dir; a level's radiance is its
  direct light plus the mean of its children's (mod.rs:132-196).

Every function takes its arrays in one dtype (float32, or bfloat16 for
the control) and runs on their device.  `radiance` is differentiable to
the scene's live vertices (through the normals) and albedo, and to the
rays; the closest-hit selection is made without autograd on a fixed copy
of the triangles and t, u, v of each winner are computed again from the
live rays, so no gradient reaches the fixed copy.
"""

from __future__ import annotations

import torch

EPS = 1.1920929e-07
MISS = float("inf")
HIT_OFFSET = 1e-5
SHADOW_OFFSET = 0.01
SHADOW_T = (0.01, 1.0)


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    n = torch.sqrt(dot(v, v))[..., None]
    return v / torch.where(n > 0, n, torch.ones_like(n))


def primary_rays(rotation, origin, max_xy, px, py, jitter, width, height):
    """Rays through pixels (px, py) + jitter (R, 2); rotation (4, 4),
    origin (3,) and max_xy are the camera's (scene.Camera.matrices)."""
    dx = -max_xy + 2.0 * max_xy * ((px + jitter[:, 0]) / width)
    dy = -max_xy + 2.0 * max_xy * ((py + jitter[:, 1]) / height)
    d = torch.stack([dx, -dy, torch.ones_like(dx)], -1)
    dirs = d[:, 0:1] * rotation[0, :3] + d[:, 1:2] * rotation[1, :3] \
        + rotation[2, :3]
    return origin.expand(dirs.shape), dirs


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore of rays (..., 3) against triangles (..., 3);
    returns t (infinite where rejected), u, v."""
    p = cross(d, e2)
    det = dot(e1, p)
    ok = det.abs() >= EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (u <= 1) & (t >= 0)
    return torch.where(ok, t, torch.full_like(t, MISS)), u, v


def closest(o, d, tris, alive, pairs=1 << 23):
    """Brute-force closest hit of rays o, d (R, 3) against tris (N, 3, 3)
    without autograd: (t, index) of each ray, infinity and 0 on a miss or
    a dead ray.  Runs in blocks of about `pairs` ray-triangle pairs."""
    R, N = o.shape[0], tris.shape[0]
    best_t = torch.full((R,), MISS, dtype=o.dtype, device=o.device)
    best_i = torch.zeros((R,), dtype=torch.int64, device=o.device)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    tc = min(N, 2048)
    rc = max(1, pairs // tc)
    with torch.no_grad():
        live = alive.nonzero()[:, 0]
        for r in range(0, live.numel(), rc):
            ids = live[r:r + rc]
            oo, dd = o[ids, None, :], d[ids, None, :]
            bt = best_t[ids]
            bi = best_i[ids]
            for s in range(0, N, tc):
                t, _, _ = _mt(oo, dd, v0[None, s:s + tc], e1[None, s:s + tc],
                              e2[None, s:s + tc])
                tmin, j = t.min(dim=1)
                better = tmin < bt
                bt = torch.where(better, tmin, bt)
                bi = torch.where(better, j + s, bi)
            best_t[ids] = bt
            best_i[ids] = bi
    return best_t, best_i


def winner(o, d, tris, idx, hit):
    """t, u, v of each ray's winning triangle, from the live rays (for
    the gradient) and the fixed triangles; missed rays are computed as a
    safe ray and masked."""
    hm = hit[:, None]
    o = torch.where(hm, o, torch.zeros_like(o))
    d = torch.where(hm, d, torch.ones_like(d))
    tv = tris.detach().index_select(0, idx)
    t, u, v = _mt(o, d, tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    zero = torch.zeros_like(t)
    return (torch.where(hit, t, zero), torch.where(hit, u, zero),
            torch.where(hit, v, zero))


def texel(scene, tex_id, u, v):
    safe = tex_id.clamp(min=0)
    hw = scene["tex_hw"][safe]
    h, w = hw[:, 0], hw[:, 1]
    x = torch.minimum(torch.clamp((u.float() * w).to(torch.int64), min=0),
                      w - 1)
    y = torch.minimum(torch.clamp((v.float() * h).to(torch.int64), min=0),
                      h - 1)
    return scene["atlas"][safe, y, x]


def direct(scene, o, d, alive, isect_tris):
    """Closest hit and Phong direct light of rays o, d (R, 3).  Returns
    (radiance (R, 3), hit (R,), hit point, unit normal)."""
    t_sel, idx = closest(o, d, isect_tris, alive)
    hit = alive & torch.isfinite(t_sel)
    t, u, v = winner(o, d, isect_tris, idx, hit)
    hp = o + t[:, None] * d
    tv = scene["tri_verts"].index_select(0, idx)
    n = normalize(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    geom = scene["tri_geom"][idx]
    tex_id = scene["mat_tex"][geom]
    diffuse = torch.where((tex_id >= 0)[:, None],
                          texel(scene, tex_id, u, v).to(o.dtype),
                          scene["mat_rgb"].index_select(0, geom))
    view = normalize(d)
    acc = torch.zeros_like(o)
    for li in range(scene["light_pos"].shape[0]):
        to_l = scene["light_pos"][li] - hp
        tl = normalize(to_l)
        dot_ln = dot(n, tl)
        facing = dot_ln >= 0
        test = hit & facing
        ts, _ = closest(hp + SHADOW_OFFSET * to_l, to_l, isect_tris, test)
        blocked = (ts > SHADOW_T[0]) & (ts < SHADOW_T[1])
        refl = 2.0 * dot_ln[:, None] * n - tl
        s = dot(view, refl)
        for _ in range(5):              # s ** 32 by repeated squaring
            s = s * s
        contrib = (diffuse * dot_ln[:, None] + s[:, None]) \
            * scene["light_color"][li]
        lit = test & ~blocked
        acc = acc + torch.where(lit[:, None], contrib, torch.zeros_like(acc))
    return acc, hit, hp, n


def children(hp, n, hit, gauss):
    """Child rays of each parent along its Gaussian draws gauss (R, b, 3):
    (origins, dirs, alive), each (R * b, ...) parent-major."""
    b = gauss.shape[1]
    g = normalize(gauss)
    g = torch.where((dot(g, n[:, None, :]) < 0)[..., None], -g, g)
    d = g.reshape(-1, 3)
    o = hp.repeat_interleave(b, dim=0) + HIT_OFFSET * d
    return o, d, hit.repeat_interleave(b)


def radiance(scene, o, d, g0, g1, isect_tris):
    """Radiance (R, 3) of primary rays o, d (R, 3) with two bounce
    levels: g0 (R, 2, 3) the Gaussians of the two level-1 children of
    each ray, g1 (R, 2, 3) those of each level-1 child's one child.
    `scene` holds tensors tri_verts (N, 3, 3), tri_geom, mat_rgb,
    mat_tex, light_pos, light_color, atlas, tex_hw; `isect_tris` the
    fixed triangles the closest hit selects on."""
    R = o.shape[0]
    alive = torch.ones((R,), dtype=torch.bool, device=o.device)
    rad, hit, hp, n = direct(scene, o, d, alive, isect_tris)
    o1, d1, a1 = children(hp, n, hit, g0)
    r1, h1, hp1, n1 = direct(scene, o1, d1, a1, isect_tris)
    o2, d2, a2 = children(hp1, n1, h1, g1.reshape(-1, 1, 3))
    r2, _, _, _ = direct(scene, o2, d2, a2, isect_tris)
    children_rad = r1.reshape(R, 2, 3).sum(1) + r2.reshape(R, 2, 3).sum(1)
    return rad + 0.5 * children_rad


def to_device(arrays, device, dtype):
    """The numpy scene of `scene.read_scene` as tensors: floats in
    `dtype`, indices int64."""
    out = {}
    for k in ("tri_verts", "mat_rgb", "light_pos", "light_color", "atlas"):
        out[k] = torch.as_tensor(arrays[k]).to(device=device, dtype=dtype)
    for k in ("tri_geom", "mat_tex", "tex_hw"):
        out[k] = torch.as_tensor(arrays[k]).to(device=device,
                                               dtype=torch.int64)
    return out
