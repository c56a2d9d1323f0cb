"""Which draw of a sample each pixel takes: the order in which the
program's entries hand their rays to the draw source, frozen here for
the reference and the roofline's yardstick.

- `render(spp)`: the whole frame padded to 16 x 8 pixel tiles, tile by
  tile (rows of tiles, then tiles along a row), each tile row-major.
- `trace_frame_additive()`: the frame's block of rows, ordered by
  (row // 8, column // 16, row % 8, column % 16).
- the inverse step: the pixels it is given, row-major.

Within a sample, the ray at draw index i takes jitter row i, the
Gaussians of its two level-1 children from rows 2i and 2i + 1 of the
level-0 draw, and those of their children from rows 2i and 2i + 1 of
the level-1 draw.
"""

from __future__ import annotations

import numpy as np

TILE_W, TILE_H = 16, 8


def tile_pixels(width, height):
    """(px, py) of the padded frame in render order."""
    wp = -(-width // TILE_W) * TILE_W
    hp = -(-height // TILE_H) * TILE_H
    ys, xs = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")

    def swz(a):
        return (a.reshape(hp // TILE_H, TILE_H, wp // TILE_W, TILE_W)
                .transpose(0, 2, 1, 3).reshape(-1))
    return swz(xs), swz(ys)


def tile_index(px, py, width, height):
    """Draw index of pixels (px, py) in `render` order."""
    tiles_x = -(-width // TILE_W)
    tile = (py // TILE_H) * tiles_x + px // TILE_W
    return (tile * TILE_H + py % TILE_H) * TILE_W + px % TILE_W


def row_block(first_row, rows, width, height):
    """(px, py) of the block of `rows` rows from `first_row` (wrapping)
    in `trace_frame_additive` order."""
    r = (first_row + np.arange(rows)) % height
    px = np.tile(np.arange(width), rows)
    py = np.repeat(r, width)
    order = np.lexsort((px % TILE_W, py % TILE_H, px // TILE_W,
                        py // TILE_H))
    return px[order], py[order]
