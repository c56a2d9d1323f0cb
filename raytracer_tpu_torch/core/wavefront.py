"""The wavefront radiance pipeline (PyTorch port of
``raytracer_tpu/core/wavefront.py``): the reference's per-pixel
recursion unrolled into fixed ray levels over whole batches.

The reference computes radiance recursively per pixel
(raytracer_lib/src/raytracer/mod.rs:132-176): with RECURSIONS=2 and
SUB_SPREAD=1 each primary hit spawns 2 indirect rays, each of which
spawns 1 more, and each recursion level averages its children.  Here
that recursion is unrolled into fixed ray levels over whole batches:

    level 0:   R rays, weight 1
    level 1: 2*R rays, weight 1/2   (fan-out 2 = spread * recursions)
    level 2: 2*R rays, weight 1/2   (fan-out 1)

Two forms compute the same radiance:

- `trace_radiance`, the composable wavefront over any intersector
  (brute force, cluster grid, BVH): per level one closest-hit query, the
  shading context (core/shade.py), one occlusion query for the
  light-major shadow batch, and the bounce rays, sorted by a spatial key
  before they are traced;
- `trace_radiance_fused`, for an intersector with the fused kernels
  (ops/cuda_bvh.py): per level ONE closest-hit + spawn kernel (shadow
  rays, child rays and their sort keys built in its epilogue) and ONE
  occlusion + radiance kernel, the glue between them only the child
  sort, the canonical draws, the per-level diffuse resolution ("full" or
  "mat" records, the texel fetch) and the radiance unsort.

Random draws come from a pluggable per-sample stream with a method
`normal(level, n) -> (n, 3)` float32 tensor.  Gaussians are drawn per
sample in canonical (pixel) order with the reference's draw shapes and
ride the sorts, so every ray keeps the numbers it would get unsorted and
results do not depend on the sort.  Sorts are stable
(`torch.sort(stable=True)`); the reference's sort is not, but per-ray
results do not depend on their neighbours and the radiance is unsorted
by each ray's original index, so the results are the same.

Spans (utils/profiling.py): `rtx.level` per level, inside it the
intersector's kernel wrappers, `rtx.unsort` (the unsort and the fold)
and `rtx.sort` (the child sort and its gathers).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.sampler import hemisphere_from_gaussian
from raytracer_tpu_torch.core.shade import (finish_shade, prepare_shade,
                                            prepare_shade_fast,
                                            prepare_shade_fused, texel)
from raytracer_tpu_torch.ops.cuda_bvh import (ALIVE_LIMIT, HIT_OFFSET,
                                              SHADOW_T_MAX, SHADOW_T_MIN,
                                              sort_key)
from raytracer_tpu_torch.ops.cuda_build import refuse_autograd
from raytracer_tpu_torch.utils.profiling import span

# Compile-time knobs of the reference render loop (mod.rs:81-82).
RECURSIONS = 2
SUB_SPREAD = 1

SORT_KEY_MODES = ("dir6", "dir9", "dirmajor", "posmajor")
SORT_PAYLOADS = ("ride", "gather")


def _level_colors(scene, isect, sres):
    """Diffuse colour planes (3, N) of a fused level from the spawn
    kernel's winning records (wavefront.py:399-441): "full" records carry
    the diffuse rgb (and tex id); "mat" records carry the material id,
    which gathers both from the scene's per-material tables.  On a
    textured scene the texel at the barycentric (u, v) replaces the flat
    colour where the tex id is >= 0 (mod.rs:244-247, texture.rs:21-27).
    The planes come back contiguous, as the shadow-shade kernel takes
    them."""
    rec = sres["rec"]
    if isect.rec_format == "mat":
        mid = rec[3].long()
        rgb = scene.mat_diffuse_rgb[mid].t()
        tid = scene.mat_tex_id[mid] if isect.fused_has_textures else None
    else:
        rgb = rec[3:6]
        tid = rec[6].to(torch.int32) if isect.fused_has_textures else None
    if tid is not None:
        rgb = torch.where((tid >= 0)[None, :],
                          texel(scene, tid, sres["u"], sres["v"]).t(), rgb)
    return rgb.contiguous()


def _shadow(isect, scene, ctx, shadow_alive):
    """Occlusion for a level's shadow batch (windowed closest,
    mod.rs:224-230)."""
    if hasattr(isect, "shadow"):
        return isect.shadow(scene, ctx["shadow_origins"],
                            ctx["shadow_dirs"], alive=shadow_alive,
                            t_min=SHADOW_T_MIN, t_max=SHADOW_T_MAX)
    res = isect.query(scene, ctx["shadow_origins"], ctx["shadow_dirs"],
                      alive=shadow_alive, t_limit=SHADOW_T_MAX)
    return res["hit"] & (res["t"] > SHADOW_T_MIN) & (res["t"] < SHADOW_T_MAX)


def _unsort_radiance(rad, orig):
    """Fold sorted per-ray radiance (N, 3) back to original order: ray k
    of the sorted level came from original position orig[k].  Out of
    place, so gradients reach `rad`."""
    return torch.empty_like(rad).index_put((orig,), rad)


def _child_index(perm_total, b):
    """Original (pixel-order) index of each child of the sorted parents:
    parent k's child j is child b*perm_total[k] + j."""
    return ((perm_total * b).repeat_interleave(b)
            + torch.arange(b, device=perm_total.device)
            .repeat(perm_total.shape[0]))


def trace_radiance(scene, origins, dirs, streams, isect,
                   recursions: int = RECURSIONS, spread: int = SUB_SPREAD,
                   sort_rays: bool = True, shade_records=None,
                   has_textures: bool = True, fused_shade: bool = False,
                   sort_key_mode: str = "dir6"):
    """Radiance (R, 3) for R primary rays (origins/dirs (R, 3)), bounce
    tree unrolled, over any intersector exposing
    query(scene, o, d, alive, t_limit) -> hit dict and optionally
    shadow(...) -> blocked (the reference's Intersector generic,
    accel_intersect.rs:10-13).  `streams` holds one draw stream
    (`streams[0].normal(level, n)`).

    shade_records: optional packed (S, 8) slot records
    (shade.build_slot_records) for the forward-only shading path — one
    row gather per level instead of five scattered lookups.
    fused_shade: the intersector extracts the winning record in its
    kernel (query(emit_shade=True)), no gather at all.
    Rays that miss everything return black (mod.rs:99-110).  The bounce
    sort runs when `sort_rays` is set and the intersector has world
    bounds (brute force has none).

    Differentiable over every intersector when neither record path is
    on: shading reads the live scene arrays (`prepare_shade`), as the
    JAX training paths leave shade_records and fused_shade off
    (wavefront.py:170-174 there).  Both record paths raise under
    autograd (`cuda_build.refuse_autograd`)."""
    if shade_records is not None:
        refuse_autograd("trace_radiance(shade_records=...)", origins, dirs,
                        scene=scene)
    if len(streams) != 1:
        raise ValueError("trace_radiance takes one draw stream; pooled "
                         "samples run on the fused path")
    stream = streams[0]

    def closest(o, d, alive):
        if fused_shade:
            return isect.query(scene, o, d, alive=alive, emit_shade=True)
        return isect.query(scene, o, d, alive=alive)

    def prepare(o, d, h):
        if fused_shade:
            return prepare_shade_fused(scene, o, d, h, has_textures)
        if shade_records is not None:
            return prepare_shade_fast(scene, o, d, h, shade_records,
                                      has_textures)
        return prepare_shade(scene, o, d, h)

    R = origins.shape[0]
    radiance = torch.zeros((R, 3), dtype=torch.float32,
                           device=origins.device)
    cur_o, cur_d = origins, dirs
    parent_alive = torch.ones((R,), dtype=torch.bool, device=origins.device)
    weight, fan = 1.0, 1
    # composed permutation: sorted position -> original child position
    # (None at level 0, where rays arrive in pixel-tile order)
    perm_total = None
    do_sort = sort_rays and hasattr(isect, "world_lo")
    pending_g = None   # (n_parents, 3*b) canonical Gaussians, parent order

    for level in range(recursions + 1):
        with span("rtx.level", level=level, rays=cur_o.shape[0]):
            hit = closest(cur_o, cur_d, parent_alive)
            ctx = prepare(cur_o, cur_d, hit)
            shadow_alive = (ctx["shadow_alive"]
                            & parent_alive.repeat(ctx["num_lights"]))
            alive = parent_alive & hit["hit"]
            blocked = _shadow(isect, scene, ctx, shadow_alive)
            rad = finish_shade(scene, ctx, blocked)
            rad = torch.where(parent_alive[:, None], rad,
                              torch.zeros_like(rad))

            # fold back to pixel order (levels >= 1 are in sorted order)
            with span("rtx.unsort"):
                if perm_total is not None:
                    rad = _unsort_radiance(rad, perm_total)
                radiance = radiance + weight * rad.reshape(R, fan,
                                                           3).sum(dim=1)

            if level < recursions:
                b = spread * (recursions - level)       # mod.rs:150
                n_child = cur_o.shape[0] * b
                n_rep = ctx["normal"].repeat_interleave(b, dim=0)
                # the hit point is sanitized in prepare: missed parents
                # spawn from their (finite) origin
                hp_rep = ctx["hit_point"].repeat_interleave(b, dim=0)
                g = (stream.normal(level, n_child) if pending_g is None
                     else pending_g.reshape(n_child, 3))
                child_d = hemisphere_from_gaussian(g, n_rep)
                child_o = hp_rep + HIT_OFFSET * child_d      # mod.rs:192-193
                child_alive = alive.repeat_interleave(b)
                b_next = spread * (recursions - level - 1)
                # the next level's Gaussians, one row of 3*b_next per
                # child in canonical child order, drawn before this
                # level's sort
                g_next = (stream.normal(level + 1, n_child * b_next)
                          .reshape(n_child, 3 * b_next)
                          if level + 1 < recursions else None)
                if do_sort:
                    with span("rtx.sort"):
                        skey = sort_key(child_o, child_d, child_alive,
                                        isect.world_lo, isect.world_inv_span,
                                        mode=sort_key_mode)
                        _, p = torch.sort(skey, stable=True)
                        child_o, child_d = child_o[p], child_d[p]
                        child_alive = child_alive[p]
                        perm_total = (p if perm_total is None
                                      else _child_index(perm_total, b)[p])
                        # the draws ride the sort: sorted child k takes
                        # the row of its canonical index
                        g_next = (None if g_next is None
                                  else g_next[perm_total])
                pending_g = g_next

                cur_o, cur_d, parent_alive = child_o, child_d, child_alive
                weight = weight / b                      # mean over children
                fan = fan * b

    return radiance


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
    restores canonical order before the per-sample fold).  On the card
    the fused kernels walk per block of rays, so which of two triangles
    hit at exactly the same t wins may depend on the neighbours; t does
    not.

    Sorts are stable (`torch.sort(stable=True)`) followed by one gather
    of the payload columns.  `sort_payload` is kept for parity with the
    reference: "ride" and "gather" run this same code, which is what the
    reference's own two forms compute bit for bit.

    The fused kernels have no backward, so this path raises under
    autograd (`cuda_build.refuse_autograd`), as `pallas_call` has no VJP
    in the JAX package; `trace_radiance` without records is the
    differentiable one, over the BVH, the cluster grid or brute force.
    """
    if sort_payload not in SORT_PAYLOADS:
        raise ValueError(f"unknown sort_payload {sort_payload!r}")
    refuse_autograd("trace_radiance_fused", origins, dirs, scene=scene)
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
        with span("rtx.level", level=level, rays=n_rays):
            b = spread * (recursions - level) if level < recursions else 0
            if b and gauss is None:
                gauss = draw_gauss(level, (n_rays // pool) * b).reshape(
                    n_rays, 3 * b).t().contiguous()
            elif not b:
                gauss = torch.empty((0, n_rays), dtype=torch.float32,
                                    device=device)

            sres = isect.spawn(rays, gauss, scene.light_pos, children=b,
                               key_mode=(sort_key_mode if kernel_keys
                                         else "none"))
            rad = isect.shadow_shade(sres["shadow"], sres["rec"][0:3],
                                     _level_colors(scene, isect, sres),
                                     rays[3:6], scene.light_color)
            if L > 1:
                rad = rad.view(3, L, n_rays).sum(dim=1)

            # fold back to pixel order and accumulate
            with span("rtx.unsort"):
                if perm_total is not None:
                    unsorted = torch.empty_like(rad)
                    unsorted[:, perm_total] = rad
                    rad = unsorted
                if fan > 1:
                    rad = rad.view(3, R0, fan).sum(dim=2)
                rad_acc = rad_acc + weight * rad

            if b:
                gmat = None
                if level + 1 < recursions:
                    b_next = spread * (recursions - level - 1)
                    gmat = draw_gauss(level + 1,
                                      (n_rays // pool) * b * b_next).reshape(
                                          n_rays * b, 3 * b_next)

                with span("rtx.sort"):
                    child = sres["children"]                 # (6, n_rays*b)
                    if kernel_keys:
                        skey = sres["keys"]
                    else:
                        alive = child[0].abs() < ALIVE_LIMIT
                        skey = sort_key(child[0:3].t(), child[3:6].t(),
                                        alive, isect.world_lo,
                                        isect.world_inv_span,
                                        mode=sort_key_mode)
                    orig = (None if perm_total is None
                            else _child_index(perm_total, b))
                    _, p = torch.sort(skey, stable=True)
                    rays = child.index_select(1, p)
                    perm_total = p if orig is None else orig[p]
                    gauss = (None if gmat is None
                             else gmat.index_select(0, perm_total).t()
                             .contiguous())
                weight = weight / b
                fan = fan * b

    return rad_acc.t()
