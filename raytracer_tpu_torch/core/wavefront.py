"""The fused wavefront radiance pipeline (PyTorch port of
``trace_radiance_fused`` in ``raytracer_tpu/core/wavefront.py``).

The reference computes radiance recursively per pixel
(raytracer_lib/src/raytracer/mod.rs:132-176): with RECURSIONS=2 and
SUB_SPREAD=1 each primary hit spawns 2 indirect rays, each of which
spawns 1 more, and each recursion level averages its children.  Here
that recursion is unrolled into fixed ray levels over whole batches:

    level 0:   R rays, weight 1
    level 1: 2*R rays, weight 1/2   (fan-out 2 = spread * recursions)
    level 2: 2*R rays, weight 1/2   (fan-out 1)

Each level is ONE closest-hit + spawn kernel (shadow rays, child rays
and their sort keys built in its epilogue) and ONE occlusion + radiance
kernel (ops/cuda_bvh.py).  The glue between them is the child sort, the
canonical random draws and the per-level radiance unsort.

Random draws come from a pluggable per-sample stream with a method
`normal(level, n) -> (n, 3)` float32 tensor.  Gaussians are drawn per
sample in canonical (pixel) order with the reference's draw shapes and
ride the sorts, so every ray keeps the numbers it would get unsorted and
results do not depend on the sort.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.cuda_bvh import ALIVE_LIMIT, sort_key

# Compile-time knobs of the reference render loop (mod.rs:81-82).
RECURSIONS = 2
SUB_SPREAD = 1

SORT_KEY_MODES = ("dir6", "dir9", "dirmajor", "posmajor")
SORT_PAYLOADS = ("ride", "gather")


def _texel_colors(scene, rec, u, v):
    """Diffuse colour planes (3, N) of a textured level: nearest-
    neighbour texel at the barycentric (u, v) where the record's tex id
    is >= 0, the flat colour elsewhere (mod.rs:244-247,
    texture.rs:21-27; the reference panics out of bounds, we clamp)."""
    tid = rec[6].to(torch.int32)
    safe = tid.clamp(min=0).long()
    hw = scene.tex_hw[safe]
    th, tw = hw[:, 0], hw[:, 1]
    zero = torch.zeros_like(tw)
    x = torch.minimum(torch.maximum((u * tw.float()).to(torch.int32), zero),
                      tw - 1)
    y = torch.minimum(torch.maximum((v * th.float()).to(torch.int32), zero),
                      th - 1)
    texel = scene.tex_atlas[safe, y.long(), x.long()]          # (N, 3)
    return torch.where((tid >= 0)[None, :], texel.t(), rec[3:6])


def trace_radiance_fused(scene, origins, dirs, streams, isect,
                         recursions: int = RECURSIONS,
                         spread: int = SUB_SPREAD,
                         sort_key_mode: str = "dir6",
                         pool: int = 1,
                         sort_payload: str = "ride"):
    """Radiance (R0, 3) for R0 primary rays over the fused kernels.

    origins/dirs: (R0, 3); with pool > 1 they are `pool` samples' rays
    concatenated sample-major, and `streams` holds one draw stream per
    sample (`streams[s].normal(level, n)`).  All samples' bounce rays
    enter one global sort; per-sample radiance equals pool=1 with that
    sample's stream bit for bit (per-ray kernel results do not depend on
    their neighbours, draws stay canonical per sample, and the unsort
    restores canonical order before the per-sample fold).

    Sorts are stable (`torch.sort(stable=True)`) followed by one gather
    of the payload columns.  `sort_payload` is kept for parity with the
    reference: "ride" and "gather" run this same code, which is what the
    reference's own two forms compute bit for bit.
    """
    if sort_payload not in SORT_PAYLOADS:
        raise ValueError(f"unknown sort_payload {sort_payload!r}")
    R0 = origins.shape[0]
    assert R0 % pool == 0 and len(streams) == pool
    L = scene.light_pos.shape[0]
    device = origins.device

    def draw_gauss(level, per_sample):
        """(pool * per_sample, 3) canonical Gaussians, sample-major."""
        gs = [s.normal(level, per_sample) for s in streams]
        return gs[0] if pool == 1 else torch.cat(gs)

    rays = torch.cat([origins.t(), dirs.t()]).contiguous()    # (6, R0)
    rad_acc = torch.zeros((3, R0), dtype=torch.float32, device=device)
    weight, fan = 1.0, 1
    perm_total = None
    gauss = None        # (3*b, n) canonical Gaussians riding the last sort
    kernel_keys = sort_key_mode in ("dir6", "dir9")

    for level in range(recursions + 1):
        n_rays = rays.shape[1]
        b = spread * (recursions - level) if level < recursions else 0
        if b and gauss is None:
            gauss = draw_gauss(level, (n_rays // pool) * b).reshape(
                n_rays, 3 * b).t().contiguous()
        elif not b:
            gauss = torch.empty((0, n_rays), dtype=torch.float32,
                                device=device)

        sres = isect.spawn(rays, gauss, scene.light_pos, children=b,
                           key_mode=sort_key_mode if kernel_keys else "none")
        rec = sres["rec"]
        if isect.fused_has_textures:
            color = _texel_colors(scene, rec, sres["u"], sres["v"])
        else:
            color = rec[3:6]
        rad = isect.shadow_shade(sres["shadow"], rec[0:3], color,
                                 rays[3:6], scene.light_color)
        if L > 1:
            rad = rad.view(3, L, n_rays).sum(dim=1)

        # fold back to pixel order and accumulate
        if perm_total is not None:
            unsorted = torch.empty_like(rad)
            unsorted[:, perm_total] = rad
            rad = unsorted
        if fan > 1:
            rad = rad.view(3, R0, fan).sum(dim=2)
        rad_acc = rad_acc + weight * rad

        if b:
            child = sres["children"]                     # (6, n_rays*b)
            if kernel_keys:
                skey = sres["keys"]
            else:
                alive = child[0].abs() < ALIVE_LIMIT
                skey = sort_key(child[0:3].t(), child[3:6].t(), alive,
                                isect.world_lo, isect.world_inv_span,
                                mode=sort_key_mode)
            if perm_total is None:
                orig = None
            else:
                orig = ((perm_total * b).repeat_interleave(b)
                        + torch.arange(b, device=device).repeat(n_rays))

            gmat = None
            if level + 1 < recursions:
                b_next = spread * (recursions - level - 1)
                gmat = draw_gauss(level + 1,
                                  (n_rays // pool) * b * b_next).reshape(
                                      n_rays * b, 3 * b_next)

            _, p = torch.sort(skey, stable=True)
            rays = child.index_select(1, p)
            perm_total = p if orig is None else orig[p]
            gauss = (None if gmat is None
                     else gmat.index_select(0, perm_total).t().contiguous())
            weight = weight / b
            fan = fan * b

    return rad_acc.t()
