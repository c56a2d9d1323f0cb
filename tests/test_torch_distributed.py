"""Multi-process bring-up of the port, run for real: two OS processes on
localhost join one gloo process group through
`parallel.mesh.initialize_distributed` (the port of
tests/test_distributed.py), then on both ranks:

- the group is live (a second initialize returns True), of world size 2;
- one cross-process all_reduce sums to 12.0 (the reference's DIST_OK);
- a 2-rank `render_sharded` over the fused BVH path (2 samples pooled,
  one bounce) gathers the whole film on each rank, equal bit for bit to
  the replay of both ranks' draws one sample at a time in this process;
- one sharded train step (brute force) leaves the same loss, gradient
  and parameters on both ranks, equal to the one-process step on the
  whole frame (rtol 1e-5: the ranks sum in another order).  Its draws
  are a fixed half-pixel jitter with no bounce, so the two ranks and the
  one process trace the same rays.

The worker is this file run as a script:
    python tests/test_torch_distributed.py <port> <rank>
It imports neither JAX nor the reference package.
"""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
W, H = 32, 16
TIMEOUT_S = 60


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_render_and_train_step():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        for mark in ("DIST_OK 12.0", "RENDER_OK", "TRAIN_OK"):
            assert mark in out, f"rank {rank} output:\n{out}"


# -- the worker ------------------------------------------------------------

class FixedDraws:
    """Half-pixel jitter and no Gaussians (recursions 0): every rank,
    and one process, trace the same rays whatever the split."""

    def next_sample(self, n):
        import torch
        return torch.full((n, 2), 0.5), None

    def split(self, n):
        return [self] * n


def _replay(rt, rank, size, seed, spp):
    """Rank `rank`'s share of render_sharded, one sample a wavefront."""
    import torch
    from raytracer_tpu_torch import TorchDraws
    from raytracer_tpu_torch.core.wavefront import trace_radiance_fused
    from raytracer_tpu_torch.models.camera import generate_rays
    from raytracer_tpu_torch.parallel import Mesh, pixel_grid, ray_sharding
    px, py, _ = pixel_grid(W, H, pad_to=size)
    sl = ray_sharding(Mesh(size, rank, torch.device("cpu")), len(px))
    px, py = torch.from_numpy(px[sl]), torch.from_numpy(py[sl])
    draws = TorchDraws(seed, "cpu").split(size)[rank]
    psum = torch.zeros((len(px), 3))
    psq = torch.zeros_like(psum)
    for _ in range(spp):
        jitter, stream = draws.next_sample(len(px))
        o, d = generate_rays(rt.camera.params("cpu"), px, py, jitter, W, H)
        rad = trace_radiance_fused(rt.scene_arrays, o, d, [stream],
                                   rt.intersector, rt.recursions, rt.spread)
        psum += rad
        psq += rad * rad
    return psum, psq


def _train(mesh, scene, cam, target):
    """One sharded Adam step over the albedo from grey; returns the loss
    and the albedo's gradient and value after the step."""
    import dataclasses

    import torch
    from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
    from raytracer_tpu_torch.diff.inverse import extract_params
    from raytracer_tpu_torch.parallel import (make_sharded_train_step,
                                              pixel_grid)
    px, py, _ = pixel_grid(W, H, pad_to=mesh.size)
    start = dataclasses.replace(scene, mat_diffuse_rgb=torch.full_like(
        scene.mat_diffuse_rgb, 0.5))
    params = extract_params(start, ("mat_diffuse_rgb",))
    opt = torch.optim.Adam(list(params.values()), lr=5e-2)
    step = make_sharded_train_step(mesh, BruteForceIntersector(), W, H, opt,
                                   recursions=0)
    loss, params = step(params, start, cam, px, py, target,
                        FixedDraws().split(mesh.size))
    p = params["mat_diffuse_rgb"]
    return loss, p.grad.clone(), p.detach().clone()


def worker(port, rank):
    import numpy as np
    import torch
    import torch.distributed as dist
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
    from raytracer_tpu_torch.parallel import (Mesh, initialize_distributed,
                                              make_mesh, make_sharded_render,
                                              pixel_grid)
    from raytracer_tpu_torch.parallel.mesh import (all_gather_rays,
                                                   all_reduce_sum)

    torch.set_num_threads(2)        # two ranks beside the other tests
    assert initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
        device="cpu", timeout=TIMEOUT_S / 2) is True
    try:
        assert initialize_distributed(device="cpu") is True
        assert dist.get_world_size() == 2 and dist.get_rank() == rank
        mesh = make_mesh(device="cpu")
        assert (mesh.size, mesh.rank) == (2, rank) and mesh.group is not None

        local = torch.full((4,), 1.0 + rank)      # rank 0: 1s, rank 1: 2s
        total = float(all_reduce_sum(mesh, local).sum())
        assert total == 12.0, total               # 4*1 + 4*2, on each rank
        print(f"DIST_OK {total}", flush=True)

        rt = rtx.create_raytracer_from_file(
            os.path.join(ROOT, "data", "4boxes.dae"), width=W, height=H,
            recursions=1, seed=7, spp_pool=2, device="cpu")
        assert rt.fused
        hdr = rt.render_sharded(spp=2)
        assert np.isfinite(hdr).all() and hdr.max() > 0
        parts = [_replay(rt, r, 2, 7, 2) for r in range(2)]
        for k, film in enumerate((rt.film.pixel_sum, rt.film.pixel_sum_sq)):
            want = torch.cat([p[k] for p in parts])[:W * H]
            assert torch.equal(film, want), k
        assert rt.film.num_samples.eq(2).all()
        print("RENDER_OK", flush=True)

        scene = rt.scene_arrays
        cam = rt.camera.params("cpu")
        px, py, _ = pixel_grid(W, H, pad_to=2)
        with torch.no_grad():
            target = make_sharded_render(
                Mesh(1, 0, torch.device("cpu")), BruteForceIntersector(), W,
                H, recursions=0)(scene, cam, px, py, FixedDraws().split(1))
        loss, grad, value = _train(mesh, scene, cam, target)
        both = all_gather_rays(mesh, torch.stack([grad, value]))
        assert torch.equal(both[:2], both[2:]), "ranks disagree"
        one = _train(Mesh(1, 0, torch.device("cpu")), scene, cam, target)
        for got, want in zip((loss, grad, value), one):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-7)
        assert float(loss) > 0
        print(f"TRAIN_OK loss {float(loss)}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(int(sys.argv[1]), int(sys.argv[2]))
