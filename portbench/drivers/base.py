"""What the three loops share: the configuration's scene, the draw
source handed to the program, the reference's own scene, and the
sampling of what the check compares (drawn from the seed)."""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.draws import Draws, Stream
from portbench.reference import render as ref
from portbench.reference.scene import read_scene


class SessionBase:
    unit = "unit"

    def __init__(self, port, cfg, mix, seed, device, root):
        self.port, self.cfg, self.mix = port, cfg, mix
        self.seed = seed
        self.device = torch.device(device)
        self.path = os.path.join(root, cfg["scene"])
        self.width, self.height = cfg["width"], cfg["height"]
        self.draws = Draws(seed, self.device)

    def check_fused(self, rt):
        """The configuration's fused path and record format, as run."""
        isect = rt.intersector
        if self.cfg["accel"] == "bvh" and not (
                rt.fused and isect.rec_format == self.cfg["records"]):
            raise RuntimeError(f"{self.cfg['name']}: the BVH render does "
                               f"not run the fused path on "
                               f"{self.cfg['records']!r} records")

    def rng(self, *key):
        """A numpy generator for the check's choices, from the seed and
        `key` (so the program's side and the reference's agree)."""
        return np.random.default_rng([self.seed % 2 ** 63, *key])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def load_scene(self, dtype):
        """The reference's scene as tensors on the device, and its camera."""
        arrays = read_scene(self.path)
        return ref.to_device(arrays, self.device, dtype), arrays["camera"]

    def sample_rays(self, seed, n, index, camera, px, py, dtype):
        """Primary rays and bounce draws of pixels (px, py), whose draw
        indices in their sample of `n` rays are `index`, from the sample
        with seed `seed`; the rays of the camera's current pose."""
        s = Stream(seed, self.device)
        idx = torch.as_tensor(index, device=self.device)
        jitter = s.jitter(n)[idx].to(dtype)
        g0 = s.normal(0, 2 * n).view(n, 2, 3)[idx].to(dtype)
        g1 = s.normal(1, 2 * n).view(n, 2, 3)[idx].to(dtype)
        rotation, origin = camera.matrices()
        f = dict(device=self.device, dtype=dtype)
        o, d = ref.primary_rays(
            torch.as_tensor(rotation, **f), torch.as_tensor(origin, **f),
            torch.tensor(float(camera.max_xy), **f),
            torch.as_tensor(px, **f), torch.as_tensor(py, **f), jitter,
            self.width, self.height)
        return o, d, g0, g1


def rel_sum_err(got, want, denom_mask=None):
    """sum |got - want| / sum |want| (over `denom_mask` for the
    denominator); inf where it is not a finite number."""
    num = float(np.abs(got.astype(np.float64) - want.astype(np.float64))
                .sum())
    w = np.abs(want.astype(np.float64))
    den = float((w if denom_mask is None else w[denom_mask]).sum())
    val = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
    return val if np.isfinite(val) else float("inf")
