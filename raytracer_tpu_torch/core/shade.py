"""Shading helpers of the fused path (PyTorch port of the parts of
``raytracer_tpu/core/shade.py`` it uses).

Reference quirks kept (raytracer/mod.rs:198-261): geometric normals
normalize(cross(v1-v0, v2-v0)), never flipped toward the viewer, and the
unclamped specular power 32 by repeated squaring (exact even-power
semantics for negative bases, where a float power would give NaN).
"""

from __future__ import annotations

import torch


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
