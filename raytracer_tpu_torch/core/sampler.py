"""Random direction sampling for indirect bounces (port of
``raytracer_tpu/core/sampler.py``, the deterministic half).

The reference rejection-samples a precomputed table of unit vectors
until one lies in the normal's hemisphere (reference:
raytracer_lib/src/raytracer/sample_generator.rs:15-52 +
raytracer/mod.rs:178-196): uniform on the hemisphere.  Here a 3D
Gaussian (from the caller's draw source) is normalized — uniform on the
sphere — and reflected into the normal's hemisphere: the same
distribution, branch-free.  The host-side `SampleGenerator` table is not
ported.
"""

from __future__ import annotations

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
