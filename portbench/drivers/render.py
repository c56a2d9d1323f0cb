"""Batch renders: `RayTracer.render(spp)` into a fresh film, back to back
(a closed loop of one client).  The end-to-end metric is the primary
rays of every render completed in the window over the window's time.

The check: renders drawn from the seed (and the last one), each at
pixels drawn from the seed; the reference traces every sample of those
pixels with the same draws and takes the film's mean.  The number
compared is sum |program - reference| / sum |reference| over them."""

from __future__ import annotations

import numpy as np
import torch

from portbench.draws import sample_seeds
from portbench.drivers.base import SessionBase, rel_sum_err
from portbench.layout import tile_index
from portbench.reference import render as ref

# window renders among which the check draws its picks (besides the last)
PICK_WITHIN = 32


class Session(SessionBase):
    unit = "render"

    def setup(self):
        cfg, mix = self.cfg, self.mix
        scene = self.port.models.collada.ColladaLoader.from_file(
            self.path, width=self.width, height=self.height, verbose=False)
        self.rt = self.port.RayTracer(
            scene, self.width, self.height,
            triangles_per_leaf=cfg["triangles_per_leaf"], accel=cfg["accel"],
            recursions=cfg["recursions"], spread=cfg["spread"],
            spp_pool=mix["pool"], device=self.device, draws=self.draws)
        self.check_fused(self.rt)
        self.spp = mix["spp"]
        self.done = 0
        self.picks = set(int(i) for i in self.rng(0).integers(
            0, PICK_WITHIN, size=mix["check"]["renders"] - 1))
        self.kept_renders = {}
        self.last = None
        self._render()                          # warm-up: every shape
        self.sync()

    def _render(self):
        self.rt.film.clear()
        return self.rt.render(self.spp)

    def run_unit(self, t0):
        hdr = self._render()
        i = self.done
        self.done += 1
        # keep the picks and the latest render, drop the one before
        self.kept_renders.pop(self.last, None)
        self.kept_renders[i] = hdr
        self.last = i if i not in self.picks else None

    def end_to_end(self, window_s, latencies):
        rays = self.done * self.width * self.height * self.spp
        return {"primary_mrays_s": rays / window_s / 1e6}

    def release(self):
        del self.rt

    def _pixels(self, i):
        n = self.mix["check"]["pixels"]
        flat = self.rng(1, i).choice(self.width * self.height, size=n,
                                     replace=False)
        return flat % self.width, flat // self.width

    def kept(self):
        out = {}
        for i, hdr in sorted(self.kept_renders.items()):
            px, py = self._pixels(i)
            out[i] = np.asarray(hdr)[py, px].astype(np.float32)
        return out

    def reference(self, dtype):
        scene, camera = self.load_scene(dtype)
        W, H = self.width, self.height
        n = (-(-W // 16) * 16) * (-(-H // 8) * 8)
        spp = self.spp
        last = max(self.kept_renders)
        every = sample_seeds(self.seed, (last + 2) * spp)
        out = {}
        for i in sorted(self.kept_renders):
            # the warm-up render took the first spp samples
            seeds = every[(i + 1) * spp:(i + 2) * spp]
            px, py = self._pixels(i)
            idx = tile_index(px, py, W, H)
            total = None
            for s in seeds:                     # sample by sample, as the film
                o, d, g0, g1 = self.sample_rays(s, n, idx, camera, px, py,
                                                dtype)
                with torch.no_grad():
                    rad = ref.radiance(scene, o, d, g0, g1,
                                       scene["tri_verts"]).float()
                total = rad if total is None else total + rad
            out[i] = (total * (1.0 / len(seeds))).cpu().numpy()
        return out

    def compare(self, got, want):
        keys = sorted(want)
        if sorted(got) != keys:
            return {"pixel_err": float("inf")}
        return {"pixel_err": rel_sum_err(np.stack([got[k] for k in keys]),
                                         np.stack([want[k] for k in keys]))}
