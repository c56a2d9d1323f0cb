"""The yardstick of the kernels' roofline shares, frozen here so that a
later change to the program cannot move it.

Peaks of one NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, which counts an FMA as
two operations; the port's kernels are built with --fmad=false, so each
Moller-Trumbore operation is one instruction, at 33.5 T instructions/s.
One ray-triangle test as the kernels write it costs 54 such operations
(cross products 9, det 5, |det| test 2, inverse 1, tvec 3, u 6, q 9,
v 6, t 6, acceptance 7).

A kernel's bound is max(bytes it must move / bandwidth, operations its
inputs need / rate).  The operations are 54 x the tests the rays need,
counted on the same rays by the program's per-ray counting walk
(`bvh_tests_needed`: the lanes of the segments a ray enters before its
best t), which runs after the window, off every timed path.
"""

from __future__ import annotations

import torch

from portbench.layout import tile_pixels

BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
MT_OPS = 54
BIG_T = 3.0e38


def bound_s(nbytes, tests):
    """(seconds, what bounds it) of a kernel moving `nbytes` bytes and
    needing `tests` ray-triangle tests."""
    t_bytes = nbytes / BYTES_PER_S
    t_ops = tests * MT_OPS / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def spawn_bytes(rays, gauss, light_pos, planes, bvh, children, emit_uv):
    """Bytes one spawn launch must move: its operands read once (rays,
    draws, lights, record planes, the BVH) and its outputs written once
    (t, records, shadow rays, child rays, keys, and u/v on textured
    scenes)."""
    R = rays.shape[1]
    L = light_pos.shape[0]
    outputs = 4 * R * (1 + planes.shape[0] + 6 * L + 7 * children
                       + (2 if emit_uv else 0))
    return (_nbytes(rays, gauss, light_pos, planes, bvh.tri, bvh.seg_aabb,
                    bvh.sc_aabb, bvh.orders) + outputs)


def wavefront_levels(port, rt, pool, gen):
    """The three levels of one pooled wavefront of rt's frame, the
    render's own shapes: yields (level, children, rays, gauss).  Level 0
    is `pool` jittered samples of the tile-swizzled frame; each next
    level is the spawn kernel's children sorted by their keys, as the
    wavefront sorts them.  Draws come from the generator `gen`."""
    cuda_bvh = port.ops.cuda_bvh
    isect = rt.intersector
    dev = rt.device
    px, py = (torch.from_numpy(a).to(dev)
              for a in tile_pixels(rt.width, rt.height))
    jitter = torch.rand((px.shape[0] * pool, 2), generator=gen, device=dev)
    o, d = port.models.camera.generate_rays(
        rt.camera.params(dev), px.repeat(pool), py.repeat(pool), jitter,
        rt.width, rt.height)
    rays = torch.cat([o.t(), d.t()]).contiguous()
    del o, d, jitter
    for level in range(rt.recursions + 1):
        b = rt.spread * (rt.recursions - level)
        g = torch.randn((3 * b, rays.shape[1]), generator=gen, device=dev)
        yield level, b, rays, g
        if b:
            got = cuda_bvh.bvh_spawn(
                rays, g, rt.scene_arrays.light_pos, isect.packed,
                isect.shade_planes, children=b, world_lo=isect.world_lo,
                world_inv_span=isect.world_inv_span,
                emit_uv=isect.fused_has_textures, key_mode=rt.sort_key_mode)
            _, p = torch.sort(got["keys"], stable=True)
            rays = got["children"].index_select(1, p)
            del got


def spawn_bound_s(port, rt, pool, seed):
    """Least seconds the spawn kernel could take over one pooled
    wavefront of rt's render: the sum of its three levels' bounds."""
    cuda_bvh = port.ops.cuda_bvh
    isect = rt.intersector
    gen = torch.Generator(device=rt.device)
    gen.manual_seed(seed % 2 ** 63)
    total = 0.0
    with torch.no_grad():
        for level, b, rays, g in wavefront_levels(port, rt, pool, gen):
            need = cuda_bvh.bvh_tests_needed(rays, isect.packed,
                                             t_limit=BIG_T)
            nbytes = spawn_bytes(rays, g, rt.scene_arrays.light_pos,
                                 isect.shade_planes, isect.packed, b,
                                 isect.fused_has_textures)
            total += bound_s(nbytes, int(need["lanes"].sum()))[0]
    return total
