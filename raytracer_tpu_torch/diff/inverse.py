"""Inverse rendering: optimize scene parameters from target images
(PyTorch port of ``raytracer_tpu/diff/inverse.py``).

The BASELINE.json config #5 workload: recover vertex positions and
material albedo (any floating-point scene leaves) by gradient descent on
the pixel loss.  `torch.optim.Adam` takes the place of `optax.adam`
with the same defaults (b1 0.9, b2 0.999, eps 1e-8 added outside the
square root); the two order their arithmetic differently, so loss
trajectories agree to a tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.core.engine import TorchDraws
from raytracer_tpu_torch.diff.gradients import pixel_loss
from raytracer_tpu_torch.models.types import resolve_device
from raytracer_tpu_torch.utils.profiling import span


def extract_params(scene, fields):
    """The optimized leaves of a SceneArrays: {field: a copy of its tensor
    that requires grad} (the scene itself is left as it is)."""
    return {f: getattr(scene, f).detach().clone().requires_grad_(True)
            for f in fields}


def params_from_numpy(params: dict, device=None):
    """A params dict of array-likes (e.g. the numpy values of the JAX
    package's params dict) -> the port's: tensors on `device` that
    require grad, with the arrays' dtypes."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev).requires_grad_(True)
            for k, v in params.items()}


def merge_params(scene, params: dict):
    return dataclasses.replace(scene, **params)


def make_train_step(optimizer, cam, px, py, width, height, intersector,
                    target, recursions: int = 0, spread: int = 1,
                    jitter=None):
    """One optimizer step over a dict of optimized leaves.
    `optimizer` is a torch.optim optimizer over the dict's tensors (it
    holds its own state).  Pass a fixed `jitter` (matching the target
    render) for deterministic optimization; otherwise each step
    re-jitters (stochastic loss).

    Returns step(params, scene, draws) -> (params, loss): `draws` gives
    the step's sample (see diff.gradients); params are updated in place
    and the loss is that before the update, as the JAX step returns.
    Each step runs in the span `rtx.train_step`, its parts in
    `rtx.forward`, `rtx.backward` and `rtx.optimizer`."""

    @span("rtx.train_step")
    def step(params, scene, draws):
        with span("rtx.forward"):
            optimizer.zero_grad(set_to_none=True)
            loss = pixel_loss(merge_params(scene, params), cam, px, py,
                              draws, width, height, intersector, target,
                              recursions, spread, jitter)
        with span("rtx.backward"):
            loss.backward()
        with span("rtx.optimizer"):
            optimizer.step()
        return params, loss.detach()

    return step


def optimize(scene, cam, px, py, width, height, intersector, target,
             fields=("mat_diffuse_rgb",), steps: int = 100,
             learning_rate: float = 1e-2, seed: int = 0,
             recursions: int = 0, spread: int = 1, jitter=None,
             verbose: bool = False, draws=None):
    """Run inverse rendering; returns (optimized scene, loss history).
    Each step takes the next sample of `draws` (default: a TorchDraws
    seeded from `seed` on the scene's device)."""
    params = extract_params(scene, fields)
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)
    step = make_train_step(optimizer, cam, px, py, width, height,
                           intersector, target, recursions, spread, jitter)
    if draws is None:
        draws = TorchDraws(seed, scene.tri_verts.device)
    losses = []
    for i in range(steps):
        params, loss = step(params, scene, draws)
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return merge_params(scene, {k: v.detach() for k, v in params.items()}), \
        losses
