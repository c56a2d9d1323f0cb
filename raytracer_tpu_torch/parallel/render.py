"""Sharded wavefront rendering and the sharded inverse-rendering step
(PyTorch port of ``raytracer_tpu/parallel/render.py``).

Each rank of a `Mesh` traces only its slice of the row-major pixel grid
(`pixel_grid`, padded so the ranks share it evenly) with the replicated
scene, drawing from its own source: `rank_draws[mesh.rank]`, where
`rank_draws = draws.split(mesh.size)` is the port's `_per_device_keys`
(render.py:33-37).  Every function here returns this rank's shard; the
caller gathers (`RayTracer.render_sharded` all-gathers the film moments).

Gradient flow in `make_sharded_train_step`: `torch.distributed`
collectives have no autograd, so the step all-reduces the element count
first (no grad), differentiates the local loss `local_sum /
global_count`, all-reduces every replicated parameter's gradient and
then steps the optimizer.  The sum of the local losses is the
reference's psum'd `total / count` (render.py:181-183) and the summed
gradients its transposed all-reduce.  The step runs over any
intersector of the composable wavefront; the reference's dry run trains
over the BVH.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.core.wavefront import (trace_radiance,
                                                trace_radiance_fused)
from raytracer_tpu_torch.models.camera import generate_rays
from raytracer_tpu_torch.parallel.mesh import all_reduce_sum, ray_sharding


def _local_pixels(mesh, px, py):
    """This rank's slice of the (replicated) pixel grid, on its device."""
    sl = ray_sharding(mesh, len(px))
    return (torch.as_tensor(px[sl]).to(mesh.device),
            torch.as_tensor(py[sl]).to(mesh.device))


def _sample_rays(cam, px, py, draws, width, height):
    jitter, stream = draws.next_sample(px.shape[0])
    origins, dirs = generate_rays(cam, px, py, jitter.to(px.device), width,
                                  height)
    return origins, dirs, stream


def make_sharded_render(mesh, intersector, width: int, height: int,
                        recursions: int = 2, spread: int = 1,
                        shade_records=None, has_textures: bool = True,
                        fused_shade: bool = False):
    """Returns render(scene, cam, px, py, rank_draws) -> this rank's
    radiance (R / size, 3): one sample of its slice of the pixel grid
    (px, py: (R,) with R a multiple of the mesh size) over the
    composable wavefront.  shade_records enables the forward fast
    shading path."""

    def render(scene, cam, px, py, rank_draws):
        lpx, lpy = _local_pixels(mesh, px, py)
        o, d, stream = _sample_rays(cam, lpx, lpy, rank_draws[mesh.rank],
                                    width, height)
        return trace_radiance(scene, o, d, [stream], intersector,
                              recursions, spread,
                              shade_records=shade_records,
                              has_textures=has_textures,
                              fused_shade=fused_shade)

    return render


def make_sharded_frame_loop(mesh, intersector, width: int, height: int,
                            recursions: int = 2, spread: int = 1,
                            shade_records=None, has_textures: bool = True,
                            fused_shade: bool = False,
                            fused_spawn: bool = False,
                            sort_key_mode: str = "dir6",
                            spp_pool: int = 1,
                            sort_payload: str = "ride"):
    """Whole-frame multi-spp render of this rank's slice.

    Returns frame(scene, cam, px, py, rank_draws, spp) -> (psum, psq),
    both (R / size, 3): the per-pixel radiance sum and sum of squares
    over `spp` samples, each sample drawn from `rank_draws[mesh.rank]`.

    spp_pool > 1 (requires fused_spawn, spp divisible by the pool): each
    iteration renders `spp_pool` samples in one pooled wavefront, as the
    single-device render does (render.py:104-120); the moments are
    folded sample by sample, so they equal `spp_pool` unpooled
    iterations bit for bit."""
    if spp_pool > 1 and not fused_spawn:
        raise ValueError("spp_pool > 1 needs the fused wavefront")

    def radiance(scene, origins, dirs, streams):
        if fused_spawn:
            return trace_radiance_fused(
                scene, origins, dirs, streams, intersector, recursions,
                spread, sort_key_mode=sort_key_mode, pool=len(streams),
                sort_payload=sort_payload)
        return trace_radiance(scene, origins, dirs, streams, intersector,
                              recursions, spread,
                              shade_records=shade_records,
                              has_textures=has_textures,
                              fused_shade=fused_shade,
                              sort_key_mode=sort_key_mode)

    def frame(scene, cam, px, py, rank_draws, spp):
        if spp % spp_pool:
            raise ValueError(f"spp {spp} is not a multiple of the pool "
                             f"{spp_pool}")
        lpx, lpy = _local_pixels(mesh, px, py)
        draws = rank_draws[mesh.rank]
        r = lpx.shape[0]
        psum = torch.zeros((r, 3), dtype=torch.float32, device=mesh.device)
        psq = torch.zeros_like(psum)
        for _ in range(spp // spp_pool):
            os_, ds_, streams = [], [], []
            for _ in range(spp_pool):
                o, d, stream = _sample_rays(cam, lpx, lpy, draws, width,
                                            height)
                os_.append(o)
                ds_.append(d)
                streams.append(stream)
            rad = radiance(scene, torch.cat(os_), torch.cat(ds_), streams)
            for sample in rad.view(spp_pool, r, 3):
                psum += sample
                psq += sample * sample
        return psum, psq

    return frame


def make_sharded_train_step(mesh, intersector, width: int, height: int,
                            optimizer, recursions: int = 2, spread: int = 1):
    """Sharded inverse-rendering step: optimize replicated scene
    parameters against target pixel values.

    Returns step(params, scene, cam, px, py, target, rank_draws) ->
    (loss, params).  `params` is a dict {field: leaf tensor that requires
    grad} over which `optimizer` (a torch.optim optimizer, holding its
    own state) was built; px/py/target are the whole padded frame, of
    which this rank traces its slice with one sample of
    `rank_draws[mesh.rank]`.  The loss is the global mean squared error
    before the update, the same on every rank; the parameters are
    updated in place, identically on every rank."""

    def step(params, scene, cam, px, py, target, rank_draws):
        lpx, lpy = _local_pixels(mesh, px, py)
        local_target = torch.as_tensor(
            target[ray_sharding(mesh, len(px))]).to(mesh.device)
        optimizer.zero_grad(set_to_none=True)
        merged = dataclasses.replace(scene, **params)
        o, d, stream = _sample_rays(cam, lpx, lpy, rank_draws[mesh.rank],
                                    width, height)
        rad = trace_radiance(merged, o, d, [stream], intersector,
                             recursions, spread)
        err = rad - local_target
        count = all_reduce_sum(mesh, torch.tensor(
            float(err.numel()), dtype=torch.float32, device=mesh.device))
        local = torch.sum(err * err) / count
        local.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            all_reduce_sum(mesh, p.grad)
        optimizer.step()
        return all_reduce_sum(mesh, local.detach()), params

    return step


def pixel_grid(width: int, height: int, pad_to: int = 1):
    """Full-frame pixel coordinate arrays, padded so R divides the mesh."""
    px = np.tile(np.arange(width, dtype=np.int32), height)
    py = np.repeat(np.arange(height, dtype=np.int32), width)
    r = len(px)
    pad = (-r) % pad_to
    if pad:
        px = np.concatenate([px, np.zeros(pad, np.int32)])
        py = np.concatenate([py, np.zeros(pad, np.int32)])
    return px, py, r
