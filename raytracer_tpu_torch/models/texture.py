"""Texture loading and the nearest-neighbour texel model.

Capability parity with the reference texture layer
(reference: raytracer_lib/src/scene/texture.rs):

- `from_file` decodes an image to RGB and normalizes by /256.0 (NOT /255 —
  texture.rs:34-50), keeping bit-level parity with the reference's texel
  values.
- Lookup is nearest-neighbour: x = floor(u * W), y = floor(v * H), texel =
  data[y * W + x] (texture.rs:21-27).  The reference does no clamping and
  panics out-of-bounds; the vectorized device version clamps to the valid
  range instead (u == 1.0 maps to the last texel).

Device-side sampling lives in the fused wavefront's texel fetch
(core.wavefront); this module is host-side decode only, a copy of
``raytracer_tpu/models/texture.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32


@dataclass
class Texture:
    """f32 RGB bitmap (texture.rs:6-28)."""
    data: np.ndarray  # (H, W, 3) float32

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]

    def get_texel(self, u: float, v: float) -> np.ndarray:
        """Scalar nearest-neighbour lookup (texture.rs:21-27). Host oracle
        only; raises IndexError out-of-bounds like the reference panics."""
        x = int(u * self.width)
        y = int(v * self.height)
        if not (0 <= x < self.width and 0 <= y < self.height):
            raise IndexError(f"texel ({u}, {v}) out of bounds")
        return self.data[y, x]


class TextureLoadError(Exception):
    """reference: texture.rs:54-88"""


def load_texture(path) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 with /256 normalization
    (texture.rs:34-50)."""
    try:
        from PIL import Image
        img = Image.open(path).convert("RGB")
        arr = np.asarray(img, dtype=F)
    except FileNotFoundError as e:
        raise TextureLoadError(str(e)) from e
    except Exception as e:  # decode errors -> ImageError parity
        raise TextureLoadError(f"{path}: {e}") from e
    return (arr / 256.0).astype(F)
