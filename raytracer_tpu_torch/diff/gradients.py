"""Differentiable rendering: pixels -> scene-parameter gradients (PyTorch
port of ``raytracer_tpu/diff/gradients.py``).

New capability beyond the reference (which is forward-only).  The
composable wavefront is differentiable as written, over any
intersector:

- Continuous paths: radiance is analytic in vertex positions (through
  Moller-Trumbore t/u/v and geometric normals), material albedo, light
  position/colour, texel values and camera pose; autograd flows through
  `trace_radiance` end to end.
- Discrete decisions carry no gradient: the closest-hit selection (made
  under no_grad, then t/u/v recomputed for the winner from the live
  tensors, core/intersect.py), shadow binarity, hemisphere-sample flips
  and texel snapping are piecewise constant, so visibility
  discontinuities carry no gradient by design.

Over the brute-force intersector t, u and v are recomputed from the
live `tri_verts`.  Over the BVH and the cluster grid the kernel (its
plain version on the CPU) selects and t, u and v are recomputed from the
intersector's own copy of the triangles (`core.intersect.winner_grad`),
as the JAX package's XLA path computes them: the vertex gradient then
arrives through the normals and the shading, not through t.
`scene_grads`, `make_train_step` and `optimize` take any of the three.

Random numbers come from a draw source, the port's convention
(core/engine.py): `draws.next_sample(n)` gives one sample's (n, 2) pixel
jitter and its Gaussian stream.  Each call of `render_pixels` takes one
sample, so repeated evaluations that must see the same draws (a loss at
several parameter values) each get a fresh source from the same seed.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.core.wavefront import trace_radiance
from raytracer_tpu_torch.models.camera import generate_rays


def render_pixels(scene, cam, px, py, draws, width, height, intersector,
                  recursions: int = 0, spread: int = 1, jitter=None):
    """Differentiable pixel radiance (R, 3) of pixels (px, py).  With
    jitter=None the sample's own jitter is used; pass a fixed (R, 2)
    jitter for deterministic comparisons (the sample is drawn all the
    same, so its Gaussians do not depend on it)."""
    sample_jitter, stream = draws.next_sample(px.shape[0])
    if jitter is None:
        jitter = sample_jitter
    origins, dirs = generate_rays(cam, px, py, jitter.to(px.device), width,
                                  height)
    return trace_radiance(scene, origins, dirs, [stream], intersector,
                          recursions, spread)


def pixel_loss(scene, cam, px, py, draws, width, height, intersector, target,
               recursions: int = 0, spread: int = 1, jitter=None):
    """Mean-squared pixel loss against a target image batch."""
    rad = render_pixels(scene, cam, px, py, draws, width, height, intersector,
                        recursions, spread, jitter)
    return torch.mean((rad - target) ** 2)


def _with_grad(obj):
    """A copy of a SceneArrays or CameraParams whose floating-point
    tensors are fresh leaves that require grad."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).detach().clone().requires_grad_(True)
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).is_floating_point()})


def _grads_like(obj, grads):
    """`obj`'s dataclass holding the gradient of each floating-point
    tensor (zeros where the loss does not reach it) and None for each
    integer one (jax.grad's float0 leaves)."""
    out = {}
    for f in dataclasses.fields(obj):
        t = getattr(obj, f.name)
        if t.is_floating_point():
            g = grads.pop(0)
            out[f.name] = torch.zeros_like(t) if g is None else g
        else:
            out[f.name] = None
    return dataclasses.replace(obj, **out)


def scene_grads(scene, cam, px, py, draws, width, height, intersector,
                target, recursions: int = 0, spread: int = 1, jitter=None):
    """Gradient of the pixel loss with respect to every scene leaf
    (tri_verts, materials, lights, texels) and the camera params.
    Returns (SceneArrays of gradients, CameraParams of gradients);
    integer scene leaves (tri_geom, tex ids, tex sizes) get None."""
    s, c = _with_grad(scene), _with_grad(cam)
    leaves = [getattr(o, f.name) for o in (s, c)
              for f in dataclasses.fields(o)
              if getattr(o, f.name).is_floating_point()]
    loss = pixel_loss(s, c, px, py, draws, width, height, intersector,
                      target, recursions, spread, jitter)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    return _grads_like(s, grads), _grads_like(c, grads)
