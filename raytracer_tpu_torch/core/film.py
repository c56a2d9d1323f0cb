"""Film: per-pixel accumulation of sum, sum of squares, and sample count
(PyTorch port of ``raytracer_tpu/core/film.py``).

Reference: raytracer_lib/src/raytracer/film.rs — additive accumulation
(film.rs:20-24), mean readout (film.rs:43-48), clear on camera motion
(film.rs:37-41), and the estimated-variance hook (film.rs:50-67).  The
three moments are tensors on the render device, updated in place.
"""

from __future__ import annotations

import torch


class Film:
    def __init__(self, size: int, device):
        self.size = size
        self.device = torch.device(device)
        self.clear()

    def clear(self):
        """film.rs:37-41"""
        self.pixel_sum = torch.zeros((self.size, 3), dtype=torch.float32,
                                     device=self.device)
        self.pixel_sum_sq = torch.zeros_like(self.pixel_sum)
        self.num_samples = torch.zeros((self.size,), dtype=torch.float32,
                                       device=self.device)

    def add_samples(self, pixel_idx, radiance):
        """Scatter-add a batch of samples (film.rs:20-24, batched).
        pixel_idx: (R,) int; radiance: (R, 3)."""
        idx = pixel_idx.long()
        self.pixel_sum.index_add_(0, idx, radiance)
        self.pixel_sum_sq.index_add_(0, idx, radiance * radiance)
        self.num_samples.index_add_(
            0, idx, torch.ones_like(radiance[:, 0]))

    def get_pixels(self):
        """Mean radiance (film.rs:43-48).  Unsampled pixels are NaN, like
        the reference's 1/0 multiply; the tonemap/pack stage maps them to
        white the way Rust's min/max chain does."""
        return self.pixel_sum * (1.0 / self.num_samples)[:, None]

    def get_estimated_variances(self):
        """film.rs:50-67 (unused by the reference render loop; kept as the
        adaptive-sampling hook, same *50 scaling)."""
        n = self.num_samples
        n_nm1 = n * (n - 1.0)
        n2_nm1 = n * n_nm1
        var = (self.pixel_sum_sq / n_nm1[:, None]
               - self.pixel_sum * self.pixel_sum / n2_nm1[:, None])
        return var * 50.0
