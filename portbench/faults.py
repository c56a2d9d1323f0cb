"""Faults planted underneath the timed path, to show that the check
catches them (portbench/tests) and to read what they give at the cell's
own size (portbench/readings.py).  Never used by a benchmark run.

For each kind of loop, the faults it can have on one card:
- "unchanged": a unit that leaves its state as it was (a render or a
  frame that adds nothing to the film; an optimizer step that moves
  nothing);
- "half": half of the batch left out, the mean taken over the rest
  (half the samples of a render; half the rays of a frame's block; the
  loss over half the pixels);
- "altered": an answer altered where it is produced (every radiance
  5 % brighter; the packed blue channel 16 levels up; the loss 1.5
  times what it is).

And one a textured scene can have in a fused loop on one card, left out of
`FAULTS` since a scene without a texture cannot show it:
- "flat_texels": the texel fetch left out, the material's flat colour
  kept where the texture id is >= 0 (`core.wavefront._level_colors`).
"""

from __future__ import annotations

import contextlib
import types

import torch

FAULTS = ("unchanged", "half", "altered")
TEXTURE_FAULTS = ("flat_texels",)


@contextlib.contextmanager
def _patched(obj, name, value):
    before = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, before)


def plant(port, kind, fault):
    """A context manager in which the program has `fault`."""
    if fault == "flat_texels":
        wavefront = port.core.wavefront
        colors = wavefront._level_colors

        def flat(scene, isect, sres):
            untextured = types.SimpleNamespace(rec_format=isect.rec_format,
                                               fused_has_textures=False)
            return colors(scene, untextured, sres)
        return _patched(wavefront, "_level_colors", flat)
    engine = port.core.engine
    rt = engine.RayTracer
    if kind == "render":
        if fault == "unchanged":
            return _patched(rt, "render", lambda self, spp=1: self.get_hdr())
        if fault == "half":
            render = rt.render
            return _patched(rt, "render",
                            lambda self, spp=1: render(self, spp // 2))
        fused = engine.trace_radiance_fused
        return _patched(engine, "trace_radiance_fused",
                        lambda *a, **k: fused(*a, **k) * 1.05)
    if kind == "progressive":
        if fault == "unchanged":
            def frame(self):
                self.current_row = ((self.current_row + self.rows_per_frame)
                                    % self.height)
                return self.rows_per_frame * self.width
            return _patched(rt, "trace_frame_additive", frame)
        if fault == "half":
            block = rt._row_block

            def half(self):
                px, py, idx = block(self)
                n = px.shape[0] // 2
                return px[:n], py[:n], idx[:n]
            return _patched(rt, "_row_block", half)
        tonemapped = rt.get_tonemapped_pixels

        def brighter(self):
            p = tonemapped(self)
            blue = p & 255
            return p - blue + (blue + 16).clip(max=255)
        return _patched(rt, "get_tonemapped_pixels", brighter)
    if kind == "inverse":
        inverse = port.diff.inverse
        if fault == "unchanged":
            return _patched(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        loss = inverse.pixel_loss
        if fault == "half":
            def half(scene, cam, px, py, draws, w, h, isect, target, *a):
                n = px.shape[0] // 2
                return loss(scene, cam, px[:n], py[:n], draws, w, h, isect,
                            target[:n], *a)
            return _patched(inverse, "pixel_loss", half)
        return _patched(inverse, "pixel_loss",
                        lambda *a, **k: loss(*a, **k) * 1.5)
    raise ValueError(f"no faults for {kind!r}")
