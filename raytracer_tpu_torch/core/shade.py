"""Batched Phong direct lighting with shadow rays (PyTorch port of
``raytracer_tpu/core/shade.py``).

Capability parity with the reference shading (reference:
raytracer_lib/src/raytracer/mod.rs:198-261), with every quirk kept:

- Geometric normals only: normalize(cross(v1-v0, v2-v0)), never flipped
  toward the viewer (mod.rs:198-205).
- Per light: skipped when dot(normal, to_light) < 0 (strictly; == 0
  still contributes specular, mod.rs:218-220).
- Shadow ray: origin offset by 0.01 * unnormalized to-light direction;
  blocked iff the *closest* hit satisfies 0.01 < t < 1.0
  (mod.rs:224-230).
- Phong: diffuse (colour or texel) * dot_ln + white specular
  dot(view, reflected)^32, the dot unclamped before the power, by
  repeated squaring (exact even-power semantics for negative bases,
  where a float power would give NaN) (mod.rs:239-257).
- Texture lookup: barycentric (u, v) straight into nearest-neighbour
  texel coordinates (mod.rs:244-247, texture.rs:21-27); the reference
  panics out of bounds, here the coordinates clamp.
- On a miss, t is set to 0 before the hit point is computed, so missed
  rays carry finite positions (their radiance is masked to zero).

Dot products are written out per component, (x + y) + z, the
arithmetic of the kernels' epilogues.

The float gathers (vertices by hit triangle, diffuse colour by geometry,
texels by texel) go through `ops.cuda_gather.gather_rows`, `table[idx]`
whose backward is the hand-written kernel; the texel gather does so only
when autograd will need its backward (grad mode on and the atlas
requires grad), since it then indexes the atlas as flat rows.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.cuda_gather import gather_rows


def pow32(x):
    """x**32 via repeated squaring (Rust powf(x, 32.0), mod.rs:255)."""
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    return x16 * x16


def _normalize(v):
    """v / |v| in the explicit component form (x*x + y*y) + z*z, the
    same arithmetic as the kernels' norm3 (and the reference's
    shade._normalize); zero vectors stay zero."""
    n = torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                   + v[..., 2:3] * v[..., 2:3])
    return v / torch.where(n > 0, n, torch.ones_like(n))


def _dot3(a, b):
    """Row-wise dot product of (..., 3) tensors, (x + y) + z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def texel(scene, tex_id, u, v):
    """Nearest-neighbour texel (N, 3) at barycentric (u, v) of texture
    `tex_id` (N,) (clamped to 0 where negative), coordinates clamped into
    the texture (mod.rs:244-247, texture.rs:21-27)."""
    safe = tex_id.clamp(min=0).long()
    hw = scene.tex_hw[safe]
    h, w = hw[:, 0], hw[:, 1]
    zero = torch.zeros_like(w)
    x = torch.minimum(torch.maximum((u * w.float()).to(torch.int32), zero),
                      w - 1)
    y = torch.minimum(torch.maximum((v * h.float()).to(torch.int32), zero),
                      h - 1)
    atlas = scene.tex_atlas
    if torch.is_grad_enabled() and atlas.requires_grad:
        # (T, H, W, 3) as (T * H * W, 3) rows
        _, th, tw, _ = atlas.shape
        return gather_rows(atlas.reshape(-1, 3),
                           (safe * th + y.long()) * tw + x.long())
    return atlas[safe, y.long(), x.long()]


def geometric_normal(tri_verts, tri_idx):
    """Face normal per hit (mod.rs:198-205). tri_idx: (R,) int."""
    tv = gather_rows(tri_verts, tri_idx.long())        # (R, 3, 3)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = torch.linalg.cross(e1, e2, dim=-1)
    norm = torch.sqrt((n * n).sum(dim=-1, keepdim=True))
    return n / torch.where(norm > 0, norm, torch.ones_like(norm))


def sample_diffuse(scene, tri_idx, u, v):
    """Material diffuse per hit: flat colour or nearest-neighbour texel at
    the barycentric (u, v) (mod.rs:242-248).  Returns (R, 3)."""
    geom = scene.tri_geom[tri_idx.long()].long()
    rgb = gather_rows(scene.mat_diffuse_rgb, geom)
    tex_id = scene.mat_tex_id[geom]
    return torch.where((tex_id >= 0)[:, None], texel(scene, tex_id, u, v),
                       rgb)


def build_slot_records(scene, perm, num_slots):
    """Packed per-slot shading records: one (S, 8) row per intersector
    slot = [unit normal (3), diffuse rgb (3), tex_id (1), geometry id
    (1)], built once per scene.  `perm`: (S,) packed slot -> triangle
    index (padding slots clamp to triangle 0 and are never hit)."""
    assert perm.shape[0] == num_slots
    safe = perm.long().clamp(0, scene.tri_verts.shape[0] - 1)
    tv = scene.tri_verts[safe]                              # (S, 3, 3)
    a = tv[:, 1] - tv[:, 0]
    b = tv[:, 2] - tv[:, 0]
    n = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)
    n = _normalize(n)
    geom = scene.tri_geom[safe].long()
    rgb = scene.mat_diffuse_rgb[geom]                       # (S, 3)
    tex = scene.mat_tex_id[geom].float()
    gid = geom.float()
    return torch.cat([n, rgb, tex[:, None], gid[:, None]], dim=1)


def _context(scene, origins, dirs, t, hit_mask, normal, diffuse_rgb):
    """Everything of Phong shading but the occlusion results, the shadow
    batch flattened light-major to (L*R, 3) so the caller can fold the
    occlusion queries into one traversal."""
    t = torch.where(hit_mask, t, torch.zeros_like(t))
    hit_point = origins + t[:, None] * dirs                  # (R, 3)
    view = _normalize(dirs)
    L = scene.light_pos.shape[0]
    R = hit_point.shape[0]
    to_light = scene.light_pos[:, None, :] - hit_point[None, :, :]  # (L,R,3)
    tl_n = _normalize(to_light)
    dot_ln = _dot3(normal[None], tl_n)                       # (L, R)
    facing = dot_ln >= 0.0                                   # mod.rs:218
    shadow_origin = hit_point[None] + 0.01 * to_light        # mod.rs:224-225
    # only rays that hit AND face the light need occlusion tests
    # (mod.rs:218-221); aliveness lets the kernels skip the rest
    shadow_alive = hit_mask[None] & facing
    return dict(
        hit_mask=hit_mask, normal=normal, hit_point=hit_point,
        diffuse_rgb=diffuse_rgb, view=view, tl_n=tl_n, dot_ln=dot_ln,
        facing=facing, num_lights=L,
        shadow_origins=shadow_origin.reshape(L * R, 3),
        shadow_dirs=to_light.reshape(L * R, 3),
        shadow_alive=shadow_alive.reshape(-1))


def prepare_shade(scene, origins, dirs, hit):
    """Phase 1 of Phong shading (mod.rs:207-261) from the live scene
    arrays: geometric normal and diffuse per hit triangle."""
    normal = geometric_normal(scene.tri_verts, hit["tri"])
    diffuse_rgb = sample_diffuse(scene, hit["tri"], hit["u"], hit["v"])
    return _context(scene, origins, dirs, hit["t"], hit["hit"], normal,
                    diffuse_rgb)


def _record_context(scene, origins, dirs, hit, rec, has_textures):
    normal = rec[:, 0:3]
    diffuse_rgb = rec[:, 3:6]
    if has_textures:
        tex_id = rec[:, 6].to(torch.int32)
        diffuse_rgb = torch.where(
            (tex_id >= 0)[:, None], texel(scene, tex_id, hit["u"], hit["v"]),
            diffuse_rgb)
    return _context(scene, origins, dirs, hit["t"], hit["hit"], normal,
                    diffuse_rgb)


def prepare_shade_fast(scene, origins, dirs, hit, records, has_textures):
    """Forward-only `prepare_shade`: every per-hit scene lookup comes
    from one row gather of the packed slot records (build_slot_records)
    at the hit's slot; the texel fetch runs only on textured scenes."""
    return _record_context(scene, origins, dirs, hit,
                           records[hit["slot"].long()], has_textures)


def prepare_shade_fused(scene, origins, dirs, hit, has_textures):
    """Forward-only `prepare_shade` for intersectors that extract the
    winning record in the kernel: hit["rec"] (R, 6|7) = normal xyz,
    diffuse rgb[, tex id]; no gather at all."""
    return _record_context(scene, origins, dirs, hit, hit["rec"],
                           has_textures)


def finish_shade(scene, ctx, blocked_flat):
    """Phase 2: combine occlusion results (blocked_flat: (L*R,)) into
    radiance (R, 3), zero where the primary ray missed."""
    R = ctx["hit_point"].shape[0]
    blocked = blocked_flat.reshape(ctx["num_lights"], R)
    accum = torch.zeros((R, 3), dtype=ctx["hit_point"].dtype,
                        device=ctx["hit_point"].device)
    for li in range(ctx["num_lights"]):
        dot_ln = ctx["dot_ln"][li]
        reflected = (2.0 * dot_ln[:, None] * ctx["normal"]
                     - ctx["tl_n"][li])                      # mod.rs:252-253
        spec = pow32(_dot3(ctx["view"], reflected))
        contrib = (ctx["diffuse_rgb"] * dot_ln[:, None]
                   + spec[:, None]) * scene.light_color[li]
        lit = ctx["facing"][li] & ~blocked[li] & ctx["hit_mask"]
        accum = accum + torch.where(lit[:, None], contrib,
                                    torch.zeros_like(contrib))
    return torch.where(ctx["hit_mask"][:, None], accum,
                       torch.zeros_like(accum))


def shade(scene, origins, dirs, hit, shadow_query):
    """Phong direct lighting in one call: runs the occlusion queries at
    once via shadow_query(origins, dirs, alive) -> blocked."""
    ctx = prepare_shade(scene, origins, dirs, hit)
    blocked = shadow_query(ctx["shadow_origins"], ctx["shadow_dirs"],
                           ctx["shadow_alive"])
    return finish_shade(scene, ctx, blocked)
