"""Packed two-level BVH on the GPU: the fused wavefront kernels, their
plain PyTorch versions, and the intersector that drives them (PyTorch
port of ``raytracer_tpu/ops/pallas_bvh.py``).

Two CUDA kernels (``csrc/cuda_bvh.cu``) replace the TPU kernels on the
render path:

- `bvh_spawn` <- `pallas_bvh_spawn` (pallas_bvh.py:985): closest hit of
  each ray, the winning triangle's shading record (+ u/v on textured
  scenes), per-light shadow rays, per-child bounce rays and sort keys.
- `bvh_shadow_shade` <- `pallas_bvh_shadow_shade` (pallas_bvh.py:1068):
  windowed-closest occlusion of the shadow rays and Phong radiance.

What bounds them on an H100 and what the design does about it is noted
at the top of the CUDA source.  Each wrapper runs the plain version for
tensors on the CPU only; for CUDA tensors it launches its kernel or
raises.  Each keeps a launch count (`bvh_spawn.launches`,
`bvh_shadow_shade.launches`) that only a kernel launch raises.

Rays are plane form: one (6, R) float32 tensor [ox, oy, oz, dx, dy, dz]
per batch (the TPU kernels took six (nb, 128) planes; the port needs no
tiling, so R is any size and there is no padding).  Outputs are laid out
so the wavefront glue needs no copies: shadow rays (6, L*R) light-major,
child rays (6, R*b) in parent-major interleave.

The kernels are built with nvcc for sm_90a on first use into
``build/torch_kernels/`` and bound through ctypes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

import numpy as np
import torch

from raytracer_tpu_torch.core.intersect import BIG_T, F32_EPSILON
from raytracer_tpu_torch.core.shade import _normalize, pow32
from raytracer_tpu_torch.models.types import resolve_device
from raytracer_tpu_torch.ops.bvh import build_bvh2

DEFAULT_RAY_BLOCK = 128      # CUDA threads per block (one ray each)

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

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "csrc", "cuda_bvh.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_ROOT), "build", "torch_kernels")
_LIB_PATH = os.path.join(_BUILD_DIR, "libcuda_bvh.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> str:
    """Compile csrc/cuda_bvh.cu into build/torch_kernels/libcuda_bvh.so
    (unconditionally) and return the compiler's output; `verbose` adds
    ptxas register/spill reports."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return proc.stdout + proc.stderr


def _load():
    """The bound library, built first if missing or older than its
    source."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
            build()
        lib = ctypes.CDLL(_LIB_PATH)
        P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.rtx_bvh_spawn.restype = I
        lib.rtx_bvh_spawn.argtypes = [
            P, L, P, I, P, I, P, P, I, P, P, P, L, I, I, I, I,
            Fl, Fl, Fl, Fl, Fl, Fl, I, P, P, P, P, P, P, P, I, P]
        lib.rtx_bvh_shadow_shade.restype = I
        lib.rtx_bvh_shadow_shade.argtypes = [
            P, L, L, P, P, P, P, P, P, P, P, L, I, I, I, I, P, P, I, P]
        _lib = lib
        return _lib


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(name, *tensors):
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must be on the same "
                             f"CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _event(wrapper):
    """A recorded CUDA timing event when the wrapper's `events` list is
    set (a caller timing the main path's launches), else None."""
    if wrapper.events is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _raise_on(code, name):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


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
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri[k][None, :] for k in range(9))
    ox, oy, oz, dx, dy, dz = (rays[k][:, None] for k in range(6))
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
                                  torch.minimum(1.0 - (uu + vv), tt))
                    >= 0.0)
    return torch.where(ok, tt, torch.full_like(tt, BIG_T)), uu, vv


def closest_plain(rays, tri):
    """Dense closest hit: `mt_plain` of every live ray against every
    packed slot, in slot order; the first minimal slot wins a tie (=
    strict '<' across rows, first lane within a row).  Dead rays (|ox|
    >= 1e30) miss without being tested.

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


# --- wrappers -------------------------------------------------------------


def bvh_spawn(rays, gauss, light_pos, bvh: PackedBVH, rec, *, world_lo,
              world_inv_span, children: int, emit_uv: bool,
              key_mode: str = "dir6", ray_block: int = DEFAULT_RAY_BLOCK,
              rows_out=None):
    """Fused closest hit + spawn for one wavefront level (replaces
    pallas_bvh_spawn, raytracer_tpu/ops/pallas_bvh.py:985).

    rays (6, R) f32; gauss (3*children, R) f32 canonical draws;
    light_pos (L, 3) f32; rec (n_rec, NL*C) f32 shading-record planes
    [normal xyz, diffuse rgb (, tex id)]; world_lo / world_inv_span:
    3 floats each (float32 values) for the sort key.
    rows_out: optional (R,) int32 that receives, per ray, the number of
    rows that ran Moller-Trumbore (kernel only; the work counter).

    Returns a dict: t (R,) [BIG_T on a miss]; u, v (R,) when emit_uv;
    rec (n_rec, R) winning record [0 on a miss]; shadow (6, L*R)
    light-major shadow rays; children (6, R*children) child rays in
    parent-major order (parent i's child j at i*children + j); keys
    (R*children,) int32 sort keys (2**30 for dead children)."""
    if key_mode not in KEY_MODES:
        raise ValueError(f"unknown key_mode {key_mode!r}")
    if rays.device.type == "cpu":
        return bvh_spawn_plain(rays, gauss, light_pos, bvh, rec,
                               world_lo=world_lo,
                               world_inv_span=world_inv_span,
                               children=children, emit_uv=emit_uv,
                               key_mode=key_mode)
    _check_cuda("bvh_spawn", rays, gauss, light_pos, rec, bvh.tri,
                bvh.seg_aabb, bvh.sc_aabb, bvh.orders, rows_out)
    R = rays.shape[1]
    b = children
    L = light_pos.shape[0]
    n_rec = rec.shape[0]
    if rays.shape[0] != 6 or gauss.shape != (3 * b, R):
        raise ValueError(f"bvh_spawn: rays {tuple(rays.shape)}, gauss "
                         f"{tuple(gauss.shape)} for {b} children")
    if rec.shape[1] != bvh.num_slots or not 3 <= n_rec <= 8:
        raise ValueError(f"bvh_spawn: rec {tuple(rec.shape)}")
    dev = rays.device
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.empty((R,), **f32)
    uv = torch.empty((2, R), **f32) if emit_uv else None
    rec_out = torch.empty((n_rec, R), **f32)
    shadow = torch.empty((6, L * R), **f32)
    child = torch.empty((6, R * b), **f32)
    keys = torch.empty((R * b,), dtype=torch.int32, device=dev)
    lib = _load()
    start = _event(bvh_spawn)
    code = lib.rtx_bvh_spawn(
        _ptr(rays), R, _ptr(gauss), b, _ptr(light_pos), L, _ptr(bvh.tri),
        _ptr(rec), n_rec, _ptr(bvh.seg_aabb), _ptr(bvh.sc_aabb),
        _ptr(bvh.orders), bvh.num_slots, bvh.C, bvh.S, bvh.G,
        bvh.num_superclusters, *[float(x) for x in world_lo],
        *[float(x) for x in world_inv_span], KEY_MODES[key_mode], _ptr(t),
        _ptr(uv), _ptr(rec_out), _ptr(shadow), _ptr(child), _ptr(keys),
        _ptr(rows_out), ray_block, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "bvh_spawn")
    bvh_spawn.launches += 1
    if start is not None:
        bvh_spawn.events.append((start, _event(bvh_spawn), R))
    out = dict(t=t, rec=rec_out, shadow=shadow, children=child, keys=keys)
    if emit_uv:
        out["u"], out["v"] = uv[0], uv[1]
    return out


bvh_spawn.launches = 0
bvh_spawn.events = None     # a list: (start, end, rays) of each launch


def bvh_shadow_shade(shadow_rays, normal, color, view, light_color,
                     bvh: PackedBVH, *, ray_block: int = DEFAULT_RAY_BLOCK,
                     rows_out=None):
    """Fused occlusion + Phong radiance for a light-major shadow batch
    (replaces pallas_bvh_shadow_shade, pallas_bvh.py:1068).

    shadow_rays (6, L*R) f32 from `bvh_spawn`; normal, color, view
    (3, R) f32 parent-level planes; light_color (L, 3) f32.  Returns
    (3, L*R) radiance per light chunk; the caller sums the L chunks."""
    if shadow_rays.device.type == "cpu":
        return bvh_shadow_shade_plain(shadow_rays, normal, color, view,
                                      light_color, bvh)
    _check_cuda("bvh_shadow_shade", shadow_rays, normal, color, view,
                light_color, bvh.tri, bvh.seg_aabb, bvh.sc_aabb, bvh.orders,
                rows_out)
    NS = shadow_rays.shape[1]
    R = normal.shape[1]
    L = light_color.shape[0]
    if shadow_rays.shape[0] != 6 or NS != L * R:
        raise ValueError(f"bvh_shadow_shade: {tuple(shadow_rays.shape)} "
                         f"shadow rays for {L} lights x {R} parents")
    for name, t in (("normal", normal), ("color", color), ("view", view)):
        if t.shape != (3, R):
            raise ValueError(f"bvh_shadow_shade: {name} {tuple(t.shape)}")
    out = torch.empty((3, NS), dtype=torch.float32, device=normal.device)
    lib = _load()
    start = _event(bvh_shadow_shade)
    code = lib.rtx_bvh_shadow_shade(
        _ptr(shadow_rays), NS, R, _ptr(normal), _ptr(color), _ptr(view),
        _ptr(light_color), _ptr(bvh.tri), _ptr(bvh.seg_aabb),
        _ptr(bvh.sc_aabb), _ptr(bvh.orders), bvh.num_slots, bvh.C, bvh.S,
        bvh.G, bvh.num_superclusters, _ptr(out), _ptr(rows_out), ray_block,
        torch.cuda.current_stream(normal.device).cuda_stream)
    _raise_on(code, "bvh_shadow_shade")
    bvh_shadow_shade.launches += 1
    if start is not None:
        bvh_shadow_shade.events.append((start, _event(bvh_shadow_shade), NS))
    return out


bvh_shadow_shade.launches = 0
bvh_shadow_shade.events = None


# --- the intersector -------------------------------------------------------


class BVHIntersector:
    """The packed two-level BVH on one device, driving the fused kernels
    (the fused-path subset of pallas_bvh.BVHIntersector: `query` and
    `shadow` wait for the port of pallas_bvh_closest)."""

    name = "bvh"

    def __init__(self, scene_buffers, triangles_per_leaf: int = 128,
                 group: int = 8, seg: int = 4,
                 ray_block: int = DEFAULT_RAY_BLOCK, device=None):
        bvh = build_bvh2(np.asarray(scene_buffers.tri_verts),
                         triangles_per_leaf=triangles_per_leaf, group=group,
                         seg=seg)
        self._init(bvh.perm, bvh.v0, bvh.e1, bvh.e2, bvh.seg_aabb,
                   bvh.sc_aabb, bvh.orders, group, ray_block, device)

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

    def set_shade_records(self, records, fmt: str = "full"):
        """Install packed per-slot shading records (S, 6|7) — columns
        [normal(3), diffuse(3)[, tex_id]], e.g. shade.build_slot_records —
        as (n, S) planes for the spawn kernel's winning-record epilogue.
        The compact "mat" format is not ported."""
        if fmt != "full":
            raise NotImplementedError(f"record format {fmt!r}")
        records = torch.as_tensor(records, dtype=torch.float32)
        if records.shape[0] != self.packed.num_slots or \
                records.shape[1] not in (6, 7):
            raise ValueError(f"records {tuple(records.shape)} for "
                             f"{self.packed.num_slots} slots")
        self.shade_planes = records.to(self.device).t().contiguous()

    @property
    def supports_fused_spawn(self) -> bool:
        return self.shade_planes is not None

    @property
    def fused_has_textures(self) -> bool:
        """True when the wavefront fetches texels between spawn and
        shadow_shade (7 record planes; the spawn kernel then emits u/v)."""
        return self.shade_planes is not None and self.shade_planes.shape[0] == 7

    def spawn(self, rays, gauss, light_pos, children: int,
              key_mode: str = "dir6"):
        """Fused closest + shadow-ray + child-ray construction (see
        `bvh_spawn`)."""
        assert self.shade_planes is not None, "set_shade_records() first"
        return bvh_spawn(rays, gauss, light_pos, self.packed,
                         self.shade_planes, world_lo=self.world_lo,
                         world_inv_span=self.world_inv_span,
                         children=children,
                         emit_uv=self.fused_has_textures, key_mode=key_mode,
                         ray_block=self.ray_block)

    def shadow_shade(self, shadow_rays, normal, color, view, light_color):
        """Fused occlusion + Phong radiance (see `bvh_shadow_shade`)."""
        return bvh_shadow_shade(shadow_rays, normal, color, view,
                                light_color, self.packed,
                                ray_block=self.ray_block)
