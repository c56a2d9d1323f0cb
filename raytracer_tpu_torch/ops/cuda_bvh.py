"""Packed two-level BVH on the GPU: the kernels, their plain PyTorch
versions, and the intersector that drives them (PyTorch port of
``raytracer_tpu/ops/pallas_bvh.py``).

Three CUDA kernels (``csrc/cuda_bvh.cu``) replace the TPU kernels:

- `bvh_spawn` <- `pallas_bvh_spawn` (pallas_bvh.py:985): closest hit of
  each ray, the winning triangle's shading record (+ u/v on textured
  scenes), per-light shadow rays, per-child bounce rays and sort keys.
- `bvh_shadow_shade` <- `pallas_bvh_shadow_shade` (pallas_bvh.py:1068):
  windowed-closest occlusion of the shadow rays and Phong radiance.
- `bvh_closest` <- `pallas_bvh_closest` (pallas_bvh.py:411): the
  generic closest hit (t, u, v, slot, optional record values; t only in
  shadow mode) of the composable wavefront's `query` and `shadow`.

What bounds them on an H100 and what the design does about it is noted
at the top of the CUDA source: the two fused kernels walk the BVH per
block of rays, staging each row the block needs in shared memory, and
`bvh_closest` walks the same way per warp (`walk_config` there refuses
the shapes they do not take).  Each wrapper checks its
operands' shapes on any device, then runs the plain version for tensors
on the CPU only; for CUDA tensors it launches its kernel or raises.
Each keeps a launch count (`bvh_spawn.launches`,
`bvh_shadow_shade.launches`, `bvh_closest.launches`) that only a kernel
launch raises, and can write, per ray, the ray-triangle tests its warp
ran (`tests_out`).

`bvh_tests_needed` runs the per-ray walk of the first versions on the
card as a counting entry (no plain version, no launch count, never on a
timed path): per ray, the rows it tests and the lanes of the segments it
enters before its best t, the tests the ray needs and the yardstick of
every BVH kernel's bound.

Rays are plane form: one (6, R) float32 tensor [ox, oy, oz, dx, dy, dz]
per batch (the TPU kernels took six (nb, 128) planes; the port needs no
tiling, so R is any size and there is no padding).  Outputs are laid out
so the wavefront glue needs no copies: shadow rays (6, L*R) light-major,
child rays (6, R*b) in parent-major interleave.

The kernels are built with nvcc for sm_90a on first use into
``build/torch_kernels/`` and bound through ctypes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from raytracer_tpu_torch.core.intersect import (BIG_T, moller_trumbore,
                                                winner_grad)
from raytracer_tpu_torch.core.shade import _normalize, pow32
from raytracer_tpu_torch.models.types import resolve_device
from raytracer_tpu_torch.ops import cuda_build
from raytracer_tpu_torch.ops.bvh import build_bvh2
from raytracer_tpu_torch.ops.cuda_build import (Fl, I, L, P, check_cuda,
                                                counted, cuda_stream, event,
                                                ptr, raise_on,
                                                refuse_autograd)

DEFAULT_RAY_BLOCK = 128      # CUDA threads per block (one ray each)
# what an invalid-value error of a walking kernel means
WALK_SHAPES = ("a shape the walk does not take (csrc/cuda_bvh.cu "
               "walk_config)")

DEAD_ORIGIN = 1.0e35         # sentinel origin of a dead ray
ALIVE_LIMIT = 1.0e30         # |ox| below this: the ray is alive
DEAD_KEY = 2 ** 30           # sort key of a dead child (sorts last)
HIT_OFFSET = 1e-5            # mod.rs:193 (spawn offset along the new dir)
SHADOW_OFFSET = 0.01         # mod.rs:224-225 (shadow origin offset)
SHADOW_T_MIN = 0.01          # mod.rs:227 occluder window
SHADOW_T_MAX = 1.0
KEY_MODES = {"none": 0, "dir6": 1, "dir9": 2}

# f32 operations of one ray-triangle Moller-Trumbore test as the kernel
# writes it (cross products 9, det 5, |det| test 2, inverse 1, tvec 3,
# u 6, q 9, v 6, t 6, acceptance 7): the unit of the operation bound.
# Built with --fmad=false, each is one instruction (no FMA pairs).
MT_OPS = 54

# Plain versions: rays per chunk so the (rays x slots) temporaries stay
# near 1 GB (about 20 live float32 temporaries per ray-slot pair).
_PLAIN_PAIR_BUDGET = 12_500_000


def _setup(lib):
    lib.rtx_bvh_spawn.restype = I
    lib.rtx_bvh_spawn.argtypes = [
        P, L, P, I, P, I, P, P, I, P, P, P, L, I, I, I, I,
        Fl, Fl, Fl, Fl, Fl, Fl, I, P, P, P, P, P, P, P, I, P]
    lib.rtx_bvh_shadow_shade.restype = I
    lib.rtx_bvh_shadow_shade.argtypes = [
        P, L, L, P, P, P, P, P, P, P, P, L, I, I, I, I, P, P, I, P]
    lib.rtx_bvh_closest.restype = I
    lib.rtx_bvh_closest.argtypes = [
        P, L, P, P, P, P, L, I, I, I, I, Fl, P, I, P, P, P, P, P, I, P]
    lib.rtx_bvh_tests_needed.restype = I
    lib.rtx_bvh_tests_needed.argtypes = [
        P, L, P, P, P, P, L, I, I, I, I, Fl, P, P, P, P, I, P]


def _load():
    """The bound library (csrc/cuda_bvh.cu), built first if missing or
    older than its source."""
    return cuda_build.load("cuda_bvh", _setup)


@dataclass
class PackedBVH:
    """The BVH2 arrays as the kernels read them, on one device.

    tri      (9, NL*C) f32 — v0 xyz, e1 xyz, e2 xyz planes over packed slots
    seg_aabb (NL*S, 8) f32; sc_aabb (K1, 8) f32; orders (6, K1) int32
    """
    tri: torch.Tensor
    seg_aabb: torch.Tensor
    sc_aabb: torch.Tensor
    orders: torch.Tensor
    C: int
    S: int
    G: int

    @property
    def num_slots(self) -> int:
        return self.tri.shape[1]

    @property
    def num_superclusters(self) -> int:
        return self.sc_aabb.shape[0]


# --- plain PyTorch versions ---------------------------------------------


def _norm3(x, y, z):
    """shade._normalize over three component planes."""
    return _normalize(torch.stack((x, y, z), dim=-1)).unbind(-1)


def _expand3(x):
    """Spread 7 bits to every 3rd position (Morton interleave)."""
    x = (x | (x << 8)) & 0x0100F00F
    x = (x | (x << 4)) & 0x010C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_key(origins, dirs, alive, world_lo, world_inv_span, mode="dir6"):
    """Spatial sort key of bounce rays: direction bins (major) then a
    Morton code of the spawn origin (minor); dead rays key past
    everything (2**30).  The spawn kernel builds the dir6/dir9 keys in
    its epilogue (pallas_bvh.py:868-896); this is their plain version and
    the glue's key for the other modes.  origins/dirs (N, 3); world_lo /
    world_inv_span: 3 float32 values each; "none" keys every live ray 0."""
    dev = origins.device
    if mode == "none":
        key = torch.zeros(alive.shape, dtype=torch.int32, device=dev)
        return torch.where(alive, key, torch.full_like(key, DEAD_KEY))
    lo = torch.tensor(world_lo, dtype=torch.float32, device=dev)
    inv_span = torch.tensor(world_inv_span, dtype=torch.float32, device=dev)
    q = torch.clamp((origins - lo) * inv_span * 128.0, 0.0, 127.0)
    q = q.to(torch.int32)
    morton = ((_expand3(q[:, 0]) << 2) | (_expand3(q[:, 1]) << 1)
              | _expand3(q[:, 2]))
    octant = ((dirs[:, 0] >= 0).to(torch.int32)
              + 2 * (dirs[:, 1] >= 0).to(torch.int32)
              + 4 * (dirs[:, 2] >= 0).to(torch.int32))
    if mode == "posmajor":
        key = (morton << 3) | octant
    elif mode == "dirmajor":
        key = (octant << 21) | morton
    elif mode in ("dir6", "dir9"):
        bits = 2 if mode == "dir6" else 3
        mag = dirs.abs().amax(dim=1, keepdim=True)
        qd = torch.clamp((dirs / torch.clamp(mag, min=1e-30) + 1.0)
                         * (2.0 ** (bits - 1)), 0.0,
                         float(2 ** bits - 1)).to(torch.int32)
        dirbin = (qd[:, 0] << (2 * bits)) | (qd[:, 1] << bits) | qd[:, 2]
        key = ((dirbin << 15) | (morton >> 6) if mode == "dir6"
               else (dirbin << 21) | morton)
    else:
        raise ValueError(f"unknown sort key mode {mode!r}")
    return torch.where(alive, key, torch.full_like(key, DEAD_KEY))


def mt_plain(rays, tri):
    """Moller-Trumbore of every ray against every packed slot with the
    kernels' arithmetic and acceptance expression.  rays (6, n), tri
    (9, NS).  Returns t, u, v, each (n, NS); t is BIG_T where a pair is
    rejected."""
    return moller_trumbore(*(rays[k][:, None] for k in range(6)),
                           *(tri[k][None, :] for k in range(9)))


def closest_plain(rays, tri, cull=None):
    """Dense closest hit: `mt_plain` of every live ray against every
    packed slot, in slot order; the first minimal slot wins a tie (=
    strict '<' across rows, first lane within a row).  Dead rays (|ox|
    >= 1e30) miss without being tested.  `cull(rays)`, when given,
    returns an (n, NS) bool mask of the pairs that a kernel's walk never
    tests; those pairs miss.

    Returns t (R,) [BIG_T on a miss], slot (R,) int64 [-1 on a miss],
    u, v (R,) [0 on a miss]."""
    R = rays.shape[1]
    dev = rays.device
    t_out = torch.full((R,), BIG_T, dtype=torch.float32, device=dev)
    slot = torch.full((R,), -1, dtype=torch.int64, device=dev)
    u_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    live = (rays[0].abs() < ALIVE_LIMIT).nonzero()[:, 0]
    chunk = max(1, _PLAIN_PAIR_BUDGET // max(tri.shape[1], 1))
    for s in range(0, live.numel(), chunk):
        ids = live[s:s + chunk]
        tt, uu, vv = mt_plain(rays[:, ids], tri)
        if cull is not None:
            tt = torch.where(cull(rays[:, ids]), BIG_T, tt)
        j = tt.argmin(dim=1, keepdim=True)
        tmin = tt.gather(1, j)[:, 0]
        hit = tmin < BIG_T
        zero = torch.zeros_like(tmin)
        t_out[ids] = tmin
        slot[ids] = torch.where(hit, j[:, 0], torch.full_like(j[:, 0], -1))
        u_out[ids] = torch.where(hit, uu.gather(1, j)[:, 0], zero)
        v_out[ids] = torch.where(hit, vv.gather(1, j)[:, 0], zero)
    return t_out, slot, u_out, v_out


def bvh_spawn_plain(rays, gauss, light_pos, bvh: PackedBVH, rec, *,
                    world_lo, world_inv_span, children: int,
                    emit_uv: bool, key_mode: str):
    """Plain PyTorch version of the spawn kernel (see `bvh_spawn`)."""
    R = rays.shape[1]
    b = children
    L = light_pos.shape[0]
    t, slot, uu, vv = closest_plain(rays, bvh.tri)
    ox, oy, oz, dx, dy, dz = rays.unbind(0)
    alive = ox.abs() < ALIVE_LIMIT
    hit = alive & (t < BIG_T)
    recs = torch.where(hit[None, :], rec[:, slot.clamp(min=0)],
                       torch.zeros((), dtype=rec.dtype, device=rec.device))
    out = dict(t=t, rec=recs)
    if emit_uv:
        out["u"], out["v"] = uu, vv

    t_san = torch.where(hit, t, torch.zeros_like(t))
    hpx = ox + t_san * dx
    hpy = oy + t_san * dy
    hpz = oz + t_san * dz
    nx, ny, nz = recs[0], recs[1], recs[2]
    dead = torch.full_like(t, DEAD_ORIGIN)
    one = torch.ones_like(t)

    sh = torch.empty((6, L, R), dtype=torch.float32, device=rays.device)
    for li in range(L):
        tlx = light_pos[li, 0] - hpx
        tly = light_pos[li, 1] - hpy
        tlz = light_pos[li, 2] - hpz
        tnx, tny, tnz = _norm3(tlx, tly, tlz)
        dln = nx * tnx + ny * tny + nz * tnz
        sal = hit & (dln >= 0.0)
        sh[0, li] = torch.where(sal, hpx + SHADOW_OFFSET * tlx, dead)
        sh[1, li] = torch.where(sal, hpy + SHADOW_OFFSET * tly, dead)
        sh[2, li] = torch.where(sal, hpz + SHADOW_OFFSET * tlz, dead)
        sh[3, li] = torch.where(sal, tlx, one)
        sh[4, li] = torch.where(sal, tly, one)
        sh[5, li] = torch.where(sal, tlz, one)
    out["shadow"] = sh.reshape(6, L * R)

    ch = torch.empty((6, R, b), dtype=torch.float32, device=rays.device)
    keys = torch.empty((R, b), dtype=torch.int32, device=rays.device)
    for j in range(b):
        ux, uy, uz = _norm3(gauss[3 * j], gauss[3 * j + 1], gauss[3 * j + 2])
        flip = (ux * nx + uy * ny + uz * nz) < 0.0
        cdx = torch.where(flip, -ux, ux)
        cdy = torch.where(flip, -uy, uy)
        cdz = torch.where(flip, -uz, uz)
        cox = hpx + HIT_OFFSET * cdx
        coy = hpy + HIT_OFFSET * cdy
        coz = hpz + HIT_OFFSET * cdz
        for k, (c, fill) in enumerate(((cox, dead), (coy, dead), (coz, dead),
                                       (cdx, one), (cdy, one), (cdz, one))):
            ch[k, :, j] = torch.where(hit, c, fill)
        keys[:, j] = sort_key(torch.stack((cox, coy, coz), dim=1),
                              torch.stack((cdx, cdy, cdz), dim=1), hit,
                              world_lo, world_inv_span, key_mode)
    out["children"] = ch.reshape(6, R * b)
    out["keys"] = keys.reshape(R * b)
    return out


def bvh_shadow_shade_plain(shadow_rays, normal, color, view, light_color,
                           bvh: PackedBVH):
    """Plain PyTorch version of the shadow-shade kernel (see
    `bvh_shadow_shade`)."""
    NS = shadow_rays.shape[1]
    R = normal.shape[1]
    L = light_color.shape[0]
    t, _, _, _ = closest_plain(shadow_rays, bvh.tri)
    alive = shadow_rays[0].abs() < ALIVE_LIMIT
    blocked = (t < BIG_T) & (t > SHADOW_T_MIN) & (t < SHADOW_T_MAX)
    lit = (alive & ~blocked).view(L, R)
    vx, vy, vz = _norm3(view[0], view[1], view[2])
    tnx, tny, tnz = _norm3(*shadow_rays[3:6].view(3, L, R).unbind(0))
    nx, ny, nz = normal[0], normal[1], normal[2]
    dln = nx * tnx + ny * tny + nz * tnz                     # (L, R)
    rx = 2.0 * dln * nx - tnx
    ry = 2.0 * dln * ny - tny
    rz = 2.0 * dln * nz - tnz
    s = pow32(vx * rx + vy * ry + vz * rz)
    out = torch.empty((3, L, R), dtype=torch.float32, device=normal.device)
    for k in range(3):
        contrib = (color[k] * dln + s) * light_color[:, k:k + 1]
        out[k] = torch.where(lit, contrib, torch.zeros_like(contrib))
    return out.reshape(3, NS)


def bvh_closest_plain(rays, bvh: PackedBVH, rec=None, *, shadow=False):
    """Plain PyTorch version of the closest-hit kernel (see
    `bvh_closest`): the dense closest hit, which is exact at any limit."""
    t, slot, uu, vv = closest_plain(rays, bvh.tri)
    if shadow:
        return dict(t=t)
    out = dict(t=t, u=uu, v=vv, slot=slot.to(torch.int32))
    if rec is not None:
        out["rec"] = torch.where(
            (slot >= 0)[None, :], rec[:, slot.clamp(min=0)],
            torch.zeros((), dtype=rec.dtype, device=rec.device))
    return out


# --- wrappers -------------------------------------------------------------


def bvh_spawn(rays, gauss, light_pos, bvh: PackedBVH, rec, *, world_lo,
              world_inv_span, children: int, emit_uv: bool,
              key_mode: str = "dir6", ray_block: int = DEFAULT_RAY_BLOCK,
              tests_out=None):
    """Fused closest hit + spawn for one wavefront level (replaces
    pallas_bvh_spawn, raytracer_tpu/ops/pallas_bvh.py:985).

    rays (6, R) f32; gauss (3*children, R) f32 canonical draws;
    light_pos (L, 3) f32; rec (n_rec, NL*C) f32 shading-record planes
    [normal xyz, diffuse rgb (, tex id)] or [normal xyz, material id]
    (the epilogue reads the normal only); world_lo / world_inv_span:
    3 floats each (float32 values) for the sort key.
    tests_out: optional (R,) int32 that receives, per ray, the number of
    ray-triangle tests its warp ran (kernel only).

    Returns a dict: t (R,) [BIG_T on a miss]; u, v (R,) when emit_uv;
    rec (n_rec, R) winning record [0 on a miss]; shadow (6, L*R)
    light-major shadow rays; children (6, R*children) child rays in
    parent-major order (parent i's child j at i*children + j); keys
    (R*children,) int32 sort keys (2**30 for dead children)."""
    if key_mode not in KEY_MODES:
        raise ValueError(f"unknown key_mode {key_mode!r}")
    R = rays.shape[1]
    b = children
    L = light_pos.shape[0]
    n_rec = rec.shape[0]
    if rays.shape[0] != 6 or gauss.shape != (3 * b, R):
        raise ValueError(f"bvh_spawn: rays {tuple(rays.shape)}, gauss "
                         f"{tuple(gauss.shape)} for {b} children")
    if light_pos.shape[1:] != (3,):
        raise ValueError(f"bvh_spawn: light_pos {tuple(light_pos.shape)}")
    if rec.shape[1] != bvh.num_slots or not 3 <= n_rec <= 8:
        raise ValueError(f"bvh_spawn: rec {tuple(rec.shape)}")
    if rays.device.type == "cpu":
        return bvh_spawn_plain(rays, gauss, light_pos, bvh, rec,
                               world_lo=world_lo,
                               world_inv_span=world_inv_span,
                               children=children, emit_uv=emit_uv,
                               key_mode=key_mode)
    check_cuda("bvh_spawn", rays, gauss, light_pos, rec, bvh.tri,
                bvh.seg_aabb, bvh.sc_aabb, bvh.orders, tests_out)
    dev = rays.device
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.empty((R,), **f32)
    uv = torch.empty((2, R), **f32) if emit_uv else None
    rec_out = torch.empty((n_rec, R), **f32)
    shadow = torch.empty((6, L * R), **f32)
    child = torch.empty((6, R * b), **f32)
    keys = torch.empty((R * b,), dtype=torch.int32, device=dev)
    lib = _load()
    start = event(bvh_spawn)
    code = lib.rtx_bvh_spawn(
        ptr(rays), R, ptr(gauss), b, ptr(light_pos), L, ptr(bvh.tri),
        ptr(rec), n_rec, ptr(bvh.seg_aabb), ptr(bvh.sc_aabb),
        ptr(bvh.orders), bvh.num_slots, bvh.C, bvh.S, bvh.G,
        bvh.num_superclusters, *[float(x) for x in world_lo],
        *[float(x) for x in world_inv_span], KEY_MODES[key_mode], ptr(t),
        ptr(uv), ptr(rec_out), ptr(shadow), ptr(child), ptr(keys),
        ptr(tests_out), ray_block, cuda_stream(dev))
    raise_on(code, "bvh_spawn", WALK_SHAPES)
    counted(bvh_spawn, start, R)
    out = dict(t=t, rec=rec_out, shadow=shadow, children=child, keys=keys)
    if emit_uv:
        out["u"], out["v"] = uv[0], uv[1]
    return out


bvh_spawn.launches = 0
bvh_spawn.events = None     # a list: (start, end, rays) of each launch


def bvh_shadow_shade(shadow_rays, normal, color, view, light_color,
                     bvh: PackedBVH, *, ray_block: int = DEFAULT_RAY_BLOCK,
                     tests_out=None):
    """Fused occlusion + Phong radiance for a light-major shadow batch
    (replaces pallas_bvh_shadow_shade, pallas_bvh.py:1068).

    shadow_rays (6, L*R) f32 from `bvh_spawn`; normal, color, view
    (3, R) f32 parent-level planes; light_color (L, 3) f32.  tests_out:
    optional (L*R,) int32, the ray-triangle tests each shadow ray's warp
    ran (kernel only).  Returns (3, L*R) radiance per light
    chunk; the caller sums the L chunks."""
    NS = shadow_rays.shape[1]
    R = normal.shape[1]
    L = light_color.shape[0]
    if shadow_rays.shape[0] != 6 or NS != L * R:
        raise ValueError(f"bvh_shadow_shade: {tuple(shadow_rays.shape)} "
                         f"shadow rays for {L} lights x {R} parents")
    for name, t in (("normal", normal), ("color", color), ("view", view)):
        if t.shape != (3, R):
            raise ValueError(f"bvh_shadow_shade: {name} {tuple(t.shape)}")
    if shadow_rays.device.type == "cpu":
        return bvh_shadow_shade_plain(shadow_rays, normal, color, view,
                                      light_color, bvh)
    check_cuda("bvh_shadow_shade", shadow_rays, normal, color, view,
                light_color, bvh.tri, bvh.seg_aabb, bvh.sc_aabb, bvh.orders,
                tests_out)
    out = torch.empty((3, NS), dtype=torch.float32, device=normal.device)
    lib = _load()
    start = event(bvh_shadow_shade)
    code = lib.rtx_bvh_shadow_shade(
        ptr(shadow_rays), NS, R, ptr(normal), ptr(color), ptr(view),
        ptr(light_color), ptr(bvh.tri), ptr(bvh.seg_aabb),
        ptr(bvh.sc_aabb), ptr(bvh.orders), bvh.num_slots, bvh.C, bvh.S,
        bvh.G, bvh.num_superclusters, ptr(out), ptr(tests_out), ray_block,
        cuda_stream(normal.device))
    raise_on(code, "bvh_shadow_shade", WALK_SHAPES)
    counted(bvh_shadow_shade, start, NS)
    return out


bvh_shadow_shade.launches = 0
bvh_shadow_shade.events = None


def bvh_closest(rays, bvh: PackedBVH, rec=None, *, t_limit=None,
                shadow: bool = False, exact_order=None, stream=False,
                ray_block: int = DEFAULT_RAY_BLOCK, tests_out=None):
    """Closest hit of every ray (replaces pallas_bvh_closest,
    raytracer_tpu/ops/pallas_bvh.py:411).

    rays (6, R) f32 (dead rays: |ox| >= 1e30); rec: optional (n_rec,
    NL*C) f32 record planes whose winning values come back as "rec";
    t_limit: the closest hit below it is exact, beyond it the walk may
    cull (the TPU's static limit, a runtime value here).  shadow=True
    returns t only.  `exact_order` and `stream` (the TPU kernel's
    walk-order and HBM-streaming variants) are accepted for parity and
    change nothing: one walk serves all of them.
    tests_out: optional (R,) int32 that receives, per ray, the number of
    ray-triangle tests its warp ran (kernel only).

    Returns a dict: t (R,) [BIG_T on a miss]; unless shadow: u, v (R,)
    [0 on a miss], slot (R,) int32 packed slot [-1 on a miss], and rec
    (n_rec, R) [0 on a miss] when record planes were given."""
    if shadow:
        rec = None
    R = rays.shape[1]
    if rays.shape[0] != 6:
        raise ValueError(f"bvh_closest: rays {tuple(rays.shape)}")
    n_rec = 0 if rec is None else rec.shape[0]
    if rec is not None and (rec.shape[1] != bvh.num_slots or n_rec > 8):
        raise ValueError(f"bvh_closest: rec {tuple(rec.shape)}")
    if rays.device.type == "cpu":
        return bvh_closest_plain(rays, bvh, rec, shadow=shadow)
    check_cuda("bvh_closest", rays, rec, bvh.tri, bvh.seg_aabb, bvh.sc_aabb,
               bvh.orders, tests_out)
    dev = rays.device
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.empty((R,), **f32)
    uv = None if shadow else torch.empty((2, R), **f32)
    slot = None if shadow else torch.empty((R,), dtype=torch.int32,
                                           device=dev)
    rec_out = torch.empty((n_rec, R), **f32) if n_rec else None
    limit = BIG_T if t_limit is None else float(t_limit)
    lib = _load()
    start = event(bvh_closest)
    code = lib.rtx_bvh_closest(
        ptr(rays), R, ptr(bvh.tri), ptr(bvh.seg_aabb), ptr(bvh.sc_aabb),
        ptr(bvh.orders), bvh.num_slots, bvh.C, bvh.S, bvh.G,
        bvh.num_superclusters, limit, ptr(rec), n_rec, ptr(t), ptr(uv),
        ptr(slot), ptr(rec_out), ptr(tests_out), ray_block, cuda_stream(dev))
    raise_on(code, "bvh_closest", WALK_SHAPES)
    counted(bvh_closest, start, R)
    if shadow:
        return dict(t=t)
    out = dict(t=t, u=uv[0], v=uv[1], slot=slot)
    if n_rec:
        out["rec"] = rec_out
    return out


bvh_closest.launches = 0
bvh_closest.events = None


def bvh_tests_needed(rays, bvh: PackedBVH, *, t_limit=None):
    """The tests each ray needs: the per-ray walk (one thread a ray, in
    its own direction order, gating each supercluster, row and segment
    against its best t so far) counts them on the card.  The yardstick
    of every BVH kernel's bound, on the same rays at the same t limit;
    kernel only (it raises on a CPU tensor) and never timed.

    Returns a dict of (R,) tensors: rows (int32) the rows the walk tests,
    lanes (int32) the lanes of the segments among them that the ray
    enters before its best t (the tests needed), and the walk's own
    closest hit t and slot (int32, -1 on a miss)."""
    if rays.shape[0] != 6:
        raise ValueError(f"bvh_tests_needed: rays {tuple(rays.shape)}")
    check_cuda("bvh_tests_needed", rays, bvh.tri, bvh.seg_aabb, bvh.sc_aabb,
               bvh.orders)
    R = rays.shape[1]
    dev = rays.device
    rows, lanes, slot = (torch.empty((R,), dtype=torch.int32, device=dev)
                         for _ in range(3))
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    code = _load().rtx_bvh_tests_needed(
        ptr(rays), R, ptr(bvh.tri), ptr(bvh.seg_aabb), ptr(bvh.sc_aabb),
        ptr(bvh.orders), bvh.num_slots, bvh.C, bvh.S, bvh.G,
        bvh.num_superclusters, BIG_T if t_limit is None else float(t_limit),
        ptr(rows), ptr(lanes), ptr(t), ptr(slot), DEFAULT_RAY_BLOCK,
        cuda_stream(dev))
    raise_on(code, "bvh_tests_needed")
    return dict(rows=rows, lanes=lanes, t=t, slot=slot)


# --- the intersector -------------------------------------------------------


def rays_from(origins, dirs, alive=None):
    """(R, 3) origins and directions -> (6, R) plane-form rays; rays
    where `alive` is False become dead sentinels (origin 1e35, direction
    1), which every kernel skips."""
    if alive is not None:
        a = alive[:, None]
        origins = torch.where(a, origins, torch.full_like(origins,
                                                          DEAD_ORIGIN))
        dirs = torch.where(a, dirs, torch.ones_like(dirs))
    return torch.cat([origins.t(), dirs.t()]).contiguous()


def hit_dict(res, perm):
    """The composable wavefront's hit dict from a closest-hit kernel's
    outputs: slot = where(hit, slot, 0), tri = perm[slot]
    (pallas_bvh.py:691-694); records come back (R, n_rec)."""
    t = res["t"]
    hit = t < BIG_T
    slot = torch.where(hit, res["slot"], torch.zeros_like(res["slot"]))
    out = dict(t=t, u=res["u"], v=res["v"], hit=hit, slot=slot,
               tri=torch.where(hit, perm[slot.long()],
                               torch.zeros_like(slot)))
    if "rec" in res:
        out["rec"] = res["rec"].t()
    return out


class BVHIntersector:
    """The packed two-level BVH on one device (pallas_bvh.BVHIntersector):
    the fused kernels (`spawn`, `shadow_shade`) and the generic closest
    hit (`query`, `closest`, `shadow`) of the composable wavefront.

    `query` is differentiable to the rays as the JAX package's XLA path
    is: the kernel (the plain version on the CPU) selects without
    autograd, and t, u and v of each winner are recomputed from this
    intersector's own copy of the triangles (`winner_grad`), so they
    carry no gradient to the scene's vertices.  `shadow` gives a bool
    and runs without autograd.  The fused entries (`spawn`,
    `shadow_shade`) and `query(emit_shade=True)`, whose records are
    forward-only constants, raise under autograd (see
    `cuda_build.refuse_autograd`)."""

    name = "bvh"

    def __init__(self, scene_buffers, triangles_per_leaf: int = 128,
                 group: int = 8, seg: int = 4,
                 ray_block: int = DEFAULT_RAY_BLOCK,
                 exact_order: bool | None = None, stream: bool = False,
                 device=None):
        bvh = build_bvh2(np.asarray(scene_buffers.tri_verts),
                         triangles_per_leaf=triangles_per_leaf, group=group,
                         seg=seg)
        self._init(bvh.perm, bvh.v0, bvh.e1, bvh.e2, bvh.seg_aabb,
                   bvh.sc_aabb, bvh.orders, group, ray_block, device)
        self.exact_order = exact_order
        self.stream = stream

    @classmethod
    def from_bvh_arrays(cls, perm, v0, e1, e2, leaf_aabb, seg_aabb, sc_aabb,
                        orders, group, ray_block=DEFAULT_RAY_BLOCK,
                        device=None):
        """An intersector over BVH2 arrays built elsewhere (numpy), e.g.
        by the reference's build_bvh2, so kernels can be held against the
        reference on identical inputs.  `leaf_aabb` (the per-row boxes of
        the reference's XLA path) is accepted for the BVH2 field list;
        the kernels gate on the segment and supercluster boxes."""
        self = cls.__new__(cls)
        self._init(perm, v0, e1, e2, seg_aabb, sc_aabb, orders, group,
                   ray_block, device)
        return self

    def _init(self, perm, v0, e1, e2, seg_aabb, sc_aabb, orders, group,
              ray_block, device):
        dev = resolve_device(device)
        v0, e1, e2 = (np.asarray(a, np.float32) for a in (v0, e1, e2))
        NL, C, _ = v0.shape
        seg_aabb = np.asarray(seg_aabb, np.float32)
        sc_aabb = np.asarray(sc_aabb, np.float32)
        assert NL == sc_aabb.shape[0] * group and seg_aabb.shape[0] % NL == 0
        tri = np.stack([a[:, :, c].reshape(-1) for a in (v0, e1, e2)
                        for c in range(3)])                 # (9, NL*C)

        def to(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
        self.device = dev
        self.ray_block = ray_block
        self.packed = PackedBVH(
            tri=to(tri, np.float32), seg_aabb=to(seg_aabb, np.float32),
            sc_aabb=to(sc_aabb, np.float32),
            orders=to(orders, np.int32), C=C, S=seg_aabb.shape[0] // NL,
            G=group)
        self.perm = to(np.maximum(np.asarray(perm), 0), np.int32)
        # world bounds for bounce-ray sort keys, float32 values
        lo = sc_aabb[:, 0:3].min(axis=0)
        hi = sc_aabb[:, 3:6].max(axis=0)
        inv = (1.0 / np.maximum(hi - lo, 1e-30)).astype(np.float32)
        self.world_lo = tuple(float(x) for x in lo)
        self.world_inv_span = tuple(float(x) for x in inv)
        self.shade_planes = None
        self.rec_format = "full"
        self._rec_textured = None
        self.exact_order = None
        self.stream = False

    def set_shade_records(self, records, fmt: str = "full",
                          textured: bool | None = None):
        """Install packed per-slot shading records (S, n), e.g. columns of
        shade.build_slot_records, as (n, S) planes for the spawn kernel's
        winning-record epilogue (pallas_bvh.py:561-584).

        fmt="full": columns [normal(3), diffuse(3)[, tex_id]], 6 or 7.
        fmt="mat": columns [normal(3), material id] (build_slot_records
        columns 0, 1, 2, 7); the wavefront resolves the diffuse rgb (and
        the tex id) from the scene's per-material tables.  `textured` says
        whether the scene has textures, i.e. whether the spawn kernel must
        emit u/v for the texel fetch; "mat" requires it, since a 4-column
        record cannot tell, and guessing "no" renders a textured scene
        flat."""
        if fmt not in ("full", "mat"):
            raise ValueError(f"unknown record format {fmt!r}")
        records = torch.as_tensor(records, dtype=torch.float32)
        widths = (4,) if fmt == "mat" else (6, 7)
        if records.dim() != 2 or records.shape[0] != self.packed.num_slots \
                or records.shape[1] not in widths:
            raise ValueError(f"{fmt!r} records {tuple(records.shape)} for "
                             f"{self.packed.num_slots} slots")
        if fmt == "mat" and textured is None:
            raise ValueError('set_shade_records(fmt="mat") needs textured= '
                             "(whether the scene has textures)")
        self.shade_planes = records.to(self.device).t().contiguous()
        self.rec_format = fmt
        self._rec_textured = None if textured is None else bool(textured)

    @property
    def supports_fused_spawn(self) -> bool:
        """Whole-level fusion: 4 "mat" record planes or 6/7 "full" ones."""
        if self.shade_planes is None:
            return False
        n = self.shade_planes.shape[0]
        return n == 4 if self.rec_format == "mat" else n in (6, 7)

    @property
    def supports_fused_shade(self) -> bool:
        """`query(emit_shade=True)` extracts the winning "full" records in
        the kernel (trace_radiance's fused_shade path)."""
        return self.shade_planes is not None and self.rec_format == "full"

    @property
    def fused_has_textures(self) -> bool:
        """True when the wavefront fetches texels between spawn and
        shadow_shade (the spawn kernel then emits u/v): `textured` for
        "mat" records, 7 planes for "full" ones."""
        if self.shade_planes is None:
            return False
        if self.rec_format == "mat":
            return self._rec_textured
        return self.shade_planes.shape[0] == 7

    def spawn(self, rays, gauss, light_pos, children: int,
              key_mode: str = "dir6"):
        """Fused closest + shadow-ray + child-ray construction (see
        `bvh_spawn`)."""
        assert self.shade_planes is not None, "set_shade_records() first"
        refuse_autograd("BVHIntersector.spawn", rays, gauss, light_pos)
        return bvh_spawn(rays, gauss, light_pos, self.packed,
                         self.shade_planes, world_lo=self.world_lo,
                         world_inv_span=self.world_inv_span,
                         children=children,
                         emit_uv=self.fused_has_textures, key_mode=key_mode,
                         ray_block=self.ray_block)

    def shadow_shade(self, shadow_rays, normal, color, view, light_color):
        """Fused occlusion + Phong radiance (see `bvh_shadow_shade`)."""
        refuse_autograd("BVHIntersector.shadow_shade", shadow_rays, normal,
                        color, view, light_color)
        return bvh_shadow_shade(shadow_rays, normal, color, view,
                                light_color, self.packed,
                                ray_block=self.ray_block)

    def _closest(self, rays, rec=None, t_limit=None, shadow=False):
        return bvh_closest(rays, self.packed, rec, t_limit=t_limit,
                           shadow=shadow, exact_order=self.exact_order,
                           stream=self.stream,
                           ray_block=self.ray_block)

    def query(self, scene, origins, dirs, alive=None, t_limit=None,
              emit_shade=False):
        """Generic closest hit of (R, 3) rays; dead rays (alive False)
        miss.  With emit_shade=True (after set_shade_records) the hit
        dict also carries the winning triangle's records as "rec"
        (R, n_rec), extracted in the kernel."""
        assert not emit_shade or self.supports_fused_shade, \
            "emit_shade requires full-format set_shade_records()"
        if emit_shade:
            refuse_autograd("BVHIntersector.query(emit_shade=True)",
                            origins, dirs, scene=scene)
        with torch.no_grad():
            res = self._closest(rays_from(origins, dirs, alive),
                                self.shade_planes if emit_shade else None,
                                t_limit)
        return winner_grad(origins, dirs, self.packed.tri,
                           hit_dict(res, self.perm))

    def closest(self, scene, origins, dirs, alive=None):
        return self.query(scene, origins, dirs, alive=alive)

    def shadow(self, scene, origins, dirs, alive=None, t_min=SHADOW_T_MIN,
               t_max=SHADOW_T_MAX):
        """Windowed-closest occlusion (mod.rs:224-230): blocked iff the
        closest hit lands strictly inside (t_min, t_max).  Culling past
        t_max cannot change the outcome."""
        with torch.no_grad():
            t = self._closest(rays_from(origins, dirs, alive), t_limit=t_max,
                              shadow=True)["t"]
        return (t < BIG_T) & (t > t_min) & (t < t_max)
