"""A viewer user's frames: `trace_frame_additive()` then
`get_tonemapped_pixels()`, back to back, with the camera turned after
every pass of `frames_per_pass` frames (which clears the film), by
each of the mix's turns in turn (left and right, so that the scene stays
in view however long the window).  The
end-to-end metric is the 95th percentile of the window's frames, each
timed from its start to its host array.

The check: frames drawn from the seed (and the last one); at pixels
drawn from the seed among the rows the pass has traced so far, and among
those it has not, the reference traces every sample since the camera
last moved with the same draws, takes the film's mean, tonemaps it
(x / (1 + x), NaN to white, 8 bits a channel) and compares the packed
channels: sum |program - reference| / sum of the reference's traced
channels."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.draws import sample_seeds
from portbench.drivers.base import SessionBase, rel_sum_err
from portbench.layout import row_block
from portbench.reference import render as ref

PICK_WITHIN = 256


class Session(SessionBase):
    unit = "frame"

    def setup(self):
        cfg, mix = self.cfg, self.mix
        scene = self.port.models.collada.ColladaLoader.from_file(
            self.path, width=self.width, height=self.height, verbose=False)
        self.rows = mix["rows_per_frame"]
        self.per_pass = mix["frames_per_pass"]
        self.turns = mix["rotate_y_radians"]
        self.rt = self.port.RayTracer(
            scene, self.width, self.height,
            triangles_per_leaf=cfg["triangles_per_leaf"], accel=cfg["accel"],
            recursions=cfg["recursions"], spread=cfg["spread"],
            rows_per_frame=self.rows, device=self.device, draws=self.draws)
        self.check_fused(self.rt)
        # warm-up: whole passes until the row cursor has been at every
        # position it takes (the engine keeps each position's block)
        cycle = self.height // math.gcd(self.rows, self.height)
        self.first = -(-cycle // self.per_pass) * self.per_pass
        self.frames = 0                 # every frame, warm-up included
        self.picks = set(self.first + int(i) for i in self.rng(0).integers(
            0, PICK_WITHIN, size=mix["check"]["frames"] - 1))
        self.kept_frames = {}
        self.last = None
        for _ in range(self.first):
            self._frame()
            self._turn()
        self.sync()

    def _frame(self):
        self.rt.trace_frame_additive()
        pixels = self.rt.get_tonemapped_pixels()
        g = self.frames
        self.frames += 1
        return g, pixels

    def run_unit(self, t0):
        g, pixels = self._frame()
        dt = time.perf_counter() - t0
        # keep the picks and the latest frame, drop the one before
        self.kept_frames.pop(self.last, None)
        self.kept_frames[g] = pixels
        self.last = g if g not in self.picks else None
        self._turn()
        return dt

    def _turn(self):
        """After a pass, the next of the mix's camera turns."""
        done = self.frames // self.per_pass
        if self.frames % self.per_pass == 0:
            self.rt.rotate_camera(
                y_radians=self.turns[(done - 1) % len(self.turns)])

    def end_to_end(self, window_s, latencies):
        return {"frame_p95_ms": float(np.percentile(latencies, 95)) * 1e3}

    def release(self):
        del self.rt

    def _covered(self, g):
        """Rows traced since the pass of frame g began, up to g."""
        p0 = g - g % self.per_pass
        rows = set()
        for h in range(p0, g + 1):
            first = (h * self.rows) % self.height
            rows.update(int(r) for r in
                        (first + np.arange(self.rows)) % self.height)
        return rows

    def _pixels(self, g):
        n = self.mix["check"]["pixels"]
        rng = self.rng(1, g)
        covered = np.array(sorted(self._covered(g)))
        free = np.setdiff1d(np.arange(self.height), covered)
        py = rng.choice(covered, size=n)
        px = rng.integers(0, self.width, size=n)
        if free.size:
            m = max(1, n // 8)
            py = np.concatenate([py, rng.choice(free, size=m)])
            px = np.concatenate([px, rng.integers(0, self.width, size=m)])
        return px, py

    def kept(self):
        out = {}
        for g, pixels in sorted(self.kept_frames.items()):
            px, py = self._pixels(g)
            out[g] = _unpack(np.asarray(pixels)[py * self.width + px])
        return out

    def reference(self, dtype):
        scene, camera = self.load_scene(dtype)
        W, H, n = self.width, self.height, self.rows * self.width
        seeds = sample_seeds(self.seed, max(self.kept_frames) + 1)
        out = {}
        for g in sorted(self.kept_frames):
            px, py = self._pixels(g)
            p0 = g - g % self.per_pass
            camera.y_angle = 0.0
            for k in range(p0 // self.per_pass):
                camera.add_y_angle(self.turns[k % len(self.turns)])
            total = np.zeros((px.size, 3), np.float32)
            count = np.zeros(px.size, np.float32)
            for h in range(p0, g + 1):          # frame by frame, as the film
                bx, by = row_block((h * self.rows) % H, self.rows, W, H)
                where = np.full(W * H, -1)
                where[by * W + bx] = np.arange(n)
                at = where[py * W + px]
                sel = np.nonzero(at >= 0)[0]
                if not sel.size:
                    continue
                o, d, g0, g1 = self.sample_rays(
                    seeds[h], n, at[sel], camera, px[sel],
                    py[sel], dtype)
                with torch.no_grad():
                    rad = ref.radiance(scene, o, d, g0, g1,
                                       scene["tri_verts"]).float()
                total[sel] += rad.cpu().numpy()
                count[sel] += 1.0
            with np.errstate(divide="ignore", invalid="ignore"):
                mean = total * (np.float32(1.0) / count)[:, None]
            ldr = mean / (np.float32(1.0) + mean)
            ldr = np.where(np.isnan(ldr), np.float32(1.0),
                           np.clip(ldr, 0.0, 1.0))
            levels = (ldr * np.float32(255.0)).astype(np.int64)
            out[g] = (np.concatenate([levels, np.full((px.size, 1), 255)], 1),
                      count > 0)
        return out

    def compare(self, got, want):
        keys = sorted(want)
        if sorted(got) != keys:
            return {"level_err": float("inf")}
        g = np.concatenate([got[k] if not isinstance(got[k], tuple)
                            else got[k][0] for k in keys])
        w = np.concatenate([want[k][0] for k in keys])
        traced = np.concatenate([want[k][1] for k in keys])
        mask = np.zeros(w.shape, bool)
        mask[traced, :3] = True
        return {"level_err": rel_sum_err(g, w, mask)}


def _unpack(u32):
    """Packed 0xAARRGGBB -> (n, 4) levels r, g, b, a."""
    v = np.asarray(u32).astype(np.int64)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255,
                     (v >> 24) & 255], 1)
