"""HDR -> LDR tonemapping and u32 pixel packing (PyTorch port of the
parts of ``raytracer_tpu/core/tonemap.py`` the engine uses).

Reference: raytracer_lib/src/raytracer/tonemap.rs:4-10 (per-channel
Reinhard) and scene/color.rs:85-95 (0xAARRGGBB packing).
"""

from __future__ import annotations

import torch


def simple_map(color):
    """Per-channel Reinhard x/(1+x) (tonemap.rs:4-10). color: (..., 3)."""
    return color / (1.0 + color)


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
