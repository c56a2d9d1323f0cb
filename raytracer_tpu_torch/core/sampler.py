"""Random direction sampling for indirect bounces (PyTorch port of
``raytracer_tpu/core/sampler.py``).

The reference rejection-samples a precomputed table of unit vectors
until one lies in the normal's hemisphere (reference:
raytracer_lib/src/raytracer/sample_generator.rs:15-52 +
raytracer/mod.rs:178-196): uniform on the hemisphere.  Here a 3D
Gaussian (from the caller's draw source) is normalized — uniform on the
sphere — and reflected into the normal's hemisphere: the same
distribution, branch-free.

`SampleGenerator` reproduces the reference's table-based API for
host-side oracles and tests (sample_generator.rs:5-52), in numpy: the
same seed gives the same table as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def hemisphere_from_gaussian(g, normals):
    """Normalize Gaussian draws g (..., 3) and flip each into the
    hemisphere of its normal.  The norm is the component form
    (x*x + y*y) + z*z, the arithmetic of the spawn kernel's norm3, so
    both paths give the same directions bit for bit."""
    norm = torch.sqrt(g[..., 0:1] * g[..., 0:1] + g[..., 1:2] * g[..., 1:2]
                      + g[..., 2:3] * g[..., 2:3])
    d = g / torch.where(norm > 0, norm, torch.ones_like(norm))
    dot = (d[..., 0:1] * normals[..., 0:1] + d[..., 1:2] * normals[..., 1:2]
           + d[..., 2:3] * normals[..., 2:3])
    return torch.where(dot < 0, -d, d)


def sample_hemisphere(generator, normals):
    """Uniform hemisphere directions around each normal (R, 3): unit
    vectors d with dot(d, n) >= 0, the distribution of the reference's
    rejection loop (mod.rs:186-190).  Draws from the `torch.Generator`
    `generator` (on the normals' device)."""
    g = torch.randn(normals.shape, generator=generator, dtype=normals.dtype,
                    device=normals.device)
    return hemisphere_from_gaussian(g, normals)


class SampleGenerator:
    """Host-side parity port of the reference's precomputed direction
    table (sample_generator.rs).  65,536 unit vectors, sequential and
    rng-indexed lookup."""

    NUM_SAMPLES = 1 << 16
    SAMPLE_MAX = (1 << 16) - 1

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        vecs = np.empty((self.NUM_SAMPLES, 3), dtype=np.float32)
        count = 0
        # rejection-sample inside the unit sphere, then normalize
        # (sample_generator.rs:36-52)
        while count < self.NUM_SAMPLES:
            cand = rng.uniform(-1.0, 1.0, size=(self.NUM_SAMPLES, 3)).astype(
                np.float32)
            good = cand[(cand * cand).sum(-1) < 1.0]
            take = min(len(good), self.NUM_SAMPLES - count)
            vecs[count:count + take] = good[:take]
            count += take
        self.normalized_vecs = vecs / np.linalg.norm(vecs, axis=-1,
                                                     keepdims=True)
        self.sample_idx = 0

    def normalized_vec_lookup(self):
        """sample_generator.rs:26-29"""
        self.sample_idx = (self.sample_idx + 1) % self.SAMPLE_MAX
        return self.normalized_vecs[self.sample_idx]

    def normalized_vec_pseudo(self, rng: np.random.Generator):
        """sample_generator.rs:31-34"""
        self.sample_idx = int(rng.integers(0, self.NUM_SAMPLES - 1))
        return self.normalized_vecs[self.sample_idx]
