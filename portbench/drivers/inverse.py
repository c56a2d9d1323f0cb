"""Inverse rendering: Adam steps of `diff.inverse.make_train_step` over
the BVH (`make_intersector("bvh")`, no shading records, so the closest
hits run in `bvh_closest` and the gradients through
`core.intersect.winner_grad`), every pixel of the frame at 1 sample a
step, each step on the next sample of the draws.  The end-to-end
metric is the window over the steps completed in it; each step ends in
a synchronisation.

Set-up renders the target with the program's forward of the true scene
(no autograd, a BVH of the true vertices, the draws' first sample),
starts from albedo `albedo_start` and vertices moved by `vertex_noise`
times Gaussians drawn from the seed, builds the train step over a BVH
of the start's vertices, and runs its first `checked_steps` steps
through the same call the window makes.  The check: the reference
(plain PyTorch, brute-force closest hit on the start's vertices, its own
target from the true scene, plain Adam) follows those steps with the
same draws; each step's loss, the first gradient as the optimizer holds
it (its first moment over 1 - beta1), and the parameters' change after
the steps are compared, the last two as the gap of their norms by the
worst leaf, against the reference's norm of that leaf or of the median
leaf, whichever is larger."""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench.draws import sample_seeds
from portbench.drivers.base import SessionBase
from portbench.reference import render as ref

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Session(SessionBase):
    unit = "step"

    def setup(self):
        cfg, mix, port, dev = self.cfg, self.mix, self.port, self.device
        W, H = self.width, self.height
        inverse = port.diff.inverse
        scene = port.models.collada.ColladaLoader.from_file(
            self.path, width=W, height=H, verbose=False)
        buffers = scene.to_buffers()
        true = buffers.to_device(dev)
        self.cam = scene.cameras[0].params(dev)
        self.px = torch.arange(W, device=dev).repeat(H)
        self.py = torch.arange(H, device=dev).repeat_interleave(W)
        self.rec = cfg["recursions"]
        tpl = cfg["triangles_per_leaf"]
        with torch.no_grad():
            target = port.diff.gradients.render_pixels(
                true, self.cam, self.px, self.py, self.draws, W, H,
                port.make_intersector(cfg["accel"], buffers,
                                      triangles_per_leaf=tpl, device=dev),
                recursions=self.rec, spread=cfg["spread"])
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed % 2 ** 63)
        self.noise = torch.randn(tuple(true.tri_verts.shape), generator=gen,
                                 device=dev)
        self.start = inverse.merge_params(true, {
            "mat_diffuse_rgb": torch.full_like(true.mat_diffuse_rgb,
                                               mix["albedo_start"]),
            "tri_verts": true.tri_verts + mix["vertex_noise"] * self.noise})
        self.fields = list(mix["learning_rates"])
        self.params = inverse.extract_params(self.start, self.fields)
        self.opt = torch.optim.Adam(
            [{"params": [self.params[f]], "lr": mix["learning_rates"][f]}
             for f in self.fields], betas=BETAS, eps=ADAM_EPS)
        isect = port.make_intersector(
            cfg["accel"], types.SimpleNamespace(
                tri_verts=self.start.tri_verts.detach().cpu().numpy()),
            triangles_per_leaf=tpl, device=dev)
        self.train = inverse.make_train_step(
            self.opt, self.cam, self.px, self.py, W, H, isect, target,
            recursions=self.rec, spread=cfg["spread"])
        losses = []
        for k in range(mix["checked_steps"]):   # also the warm-up
            _, loss = self.train(self.params, self.start, self.draws)
            losses.append(float(loss))
            if k == 0:      # the gradient as the optimizer holds it
                first = {f: self.opt.state.get(self.params[f], {}).get(
                    "exp_avg", torch.zeros(())) / (1.0 - BETAS[0])
                    for f in self.fields}
        self.got = {
            "loss": losses,
            "grad": {f: float(g.norm()) for f, g in first.items()},
            "change": {f: float((self.params[f].detach()
                                 - getattr(self.start, f)).norm())
                       for f in self.fields}}
        self.steps = 0
        self.sync()

    def run_unit(self, t0):
        self.train(self.params, self.start, self.draws)
        self.sync()
        self.steps += 1

    def end_to_end(self, window_s, latencies):
        return {"step_s": window_s / self.steps}

    def release(self):
        del self.train, self.opt, self.params, self.start, self.cam
        del self.px, self.py

    def kept(self):
        return self.got

    def reference(self, dtype):
        """The reference's own target, start and steps in `dtype`."""
        scene, camera = self.load_scene(dtype)
        mix, W, H = self.mix, self.width, self.height
        n = W * H
        flat = np.arange(n)
        px, py = flat % W, flat // W
        seeds = sample_seeds(self.seed, mix["checked_steps"] + 1)

        def rays(k):
            return self.sample_rays(seeds[k], n, flat, camera, px, py, dtype)

        true_tris = scene["tri_verts"]
        with torch.no_grad():
            o, d, g0, g1 = rays(0)
            target = ref.radiance(scene, o, d, g0, g1, true_tris)
        start = {"tri_verts": true_tris + mix["vertex_noise"]
                 * self.noise.to(dtype),
                 "mat_diffuse_rgb": torch.full_like(scene["mat_rgb"],
                                                    mix["albedo_start"])}
        fixed = start["tri_verts"].detach().clone()
        params = {f: start[f].detach().clone() for f in self.fields}
        m = {f: torch.zeros_like(p) for f, p in params.items()}
        v = {f: torch.zeros_like(p) for f, p in params.items()}
        losses, first = [], None
        for k in range(1, mix["checked_steps"] + 1):
            leaves = {f: p.detach().requires_grad_(True)
                      for f, p in params.items()}
            live = dict(scene, tri_verts=leaves.get("tri_verts",
                                                   scene["tri_verts"]),
                        mat_rgb=leaves.get("mat_diffuse_rgb",
                                           scene["mat_rgb"]))
            o, d, g0, g1 = rays(k)
            rad = ref.radiance(live, o, d, g0, g1, fixed)
            loss = torch.mean((rad - target) ** 2)
            grads = torch.autograd.grad(loss, [leaves[f]
                                               for f in self.fields])
            losses.append(float(loss.detach()))
            if first is None:
                first = {f: float(g.float().norm())
                         for f, g in zip(self.fields, grads)}
            with torch.no_grad():
                for f, g in zip(self.fields, grads):
                    lr = mix["learning_rates"][f]
                    m[f] = BETAS[0] * m[f] + (1 - BETAS[0]) * g
                    v[f] = BETAS[1] * v[f] + (1 - BETAS[1]) * g * g
                    m_hat = m[f] / (1 - BETAS[0] ** k)
                    v_hat = v[f] / (1 - BETAS[1] ** k)
                    params[f] = params[f] - lr * m_hat / (torch.sqrt(v_hat)
                                                         + ADAM_EPS)
            del rad, loss, grads, leaves, live
        return {"loss": losses, "grad": first,
                "change": {f: float((params[f] - start[f]).float().norm())
                           for f in self.fields}}

    def compare(self, got, want):
        lg = max(abs(a - b) / abs(b) if b else float("inf")
                 for a, b in zip(got["loss"], want["loss"]))
        out = {"loss_gap": lg}
        for key in ("grad", "change"):
            norms = list(want[key].values())
            med = float(np.median(norms))
            out[f"{key}_gap"] = max(
                abs(got[key][f] - w) / max(w, med) if max(w, med) > 0
                else float("inf") for f, w in want[key].items())
        return {k: (x if np.isfinite(x) else float("inf"))
                for k, x in out.items()}
