"""HDR -> LDR tonemapping and u32 pixel packing (PyTorch port of
``raytracer_tpu/core/tonemap.py``).

Reference: raytracer_lib/src/raytracer/tonemap.rs — the active
per-channel Reinhard `simple_map` (tonemap.rs:4-10), the unused but
present `luminance_simple_map`, `gamma_map` and sRGB<->XYZ conversions
(tonemap.rs:13-51) — and scene/color.rs:85-95 (0xAARRGGBB packing).
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB <-> XYZ matrices (tonemap.rs:37-51); row-vector convention
_RGB_TO_XYZ = np.array([
    [0.4124564, 0.2126729, 0.0193339],
    [0.3575761, 0.7151522, 0.119192],
    [0.1804375, 0.0721750, 0.9503041],
], dtype=np.float32)
_XYZ_TO_RGB = np.array([
    [3.2404542, -0.969266, 0.0556434],
    [-1.5371385, 1.8760108, -0.2040259],
    [-0.4985314, 0.0415560, 1.0572252],
], dtype=np.float32)


def simple_map(color):
    """Per-channel Reinhard x/(1+x) (tonemap.rs:4-10). color: (..., 3)."""
    return color / (1.0 + color)


def _mat(m, like):
    return torch.from_numpy(m).to(device=like.device, dtype=like.dtype)


def to_xyz(color):
    return color @ _mat(_RGB_TO_XYZ, color)


def to_rgb(xyz):
    return xyz @ _mat(_XYZ_TO_RGB, xyz)


def luminance_simple_map(color):
    """tonemap.rs:13-20 — Reinhard on the Y channel only."""
    xyz = to_xyz(color)
    y = xyz[..., 1:2]
    xyz = torch.cat([xyz[..., :1], y / (1.0 + y), xyz[..., 2:]], dim=-1)
    return to_rgb(xyz)


def gamma_map(color, a: float = 0.5, gamma: float = 0.5):
    """tonemap.rs:23-33 — gamma compression of the Y channel."""
    xyz = to_xyz(color)
    y = a * torch.pow(torch.clamp(xyz[..., 1:2], min=0.0), gamma)
    xyz = torch.cat([xyz[..., :1], y, xyz[..., 2:]], dim=-1)
    return to_rgb(xyz)


def pack_u32(rgb, alpha: float = 1.0):
    """RGBA -> packed 0xAARRGGBB (scene/color.rs:85-95), returned as an
    int64 tensor holding the unsigned 32-bit values (torch's uint32 has
    no shift/or kernels).

    Rust's clamp chain `x.min(1.0).max(0.0)` maps NaN to 1.0 (f32::min
    returns the non-NaN operand), so NaN pixels (unsampled film) pack as
    white; reproduce that.
    """
    x = torch.where(torch.isnan(rgb), torch.ones_like(rgb),
                    torch.clamp(rgb, 0.0, 1.0))
    q = (x * 255.0).to(torch.int64)
    a = int(min(max(alpha, 0.0), 1.0) * 255.0)
    return q[..., 2] | (q[..., 1] << 8) | (q[..., 0] << 16) | (a << 24)
