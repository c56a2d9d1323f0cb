"""Multi-rank dry run of the sharded paths (the port's counterpart of
``__graft_entry__.dryrun_multichip``).

On every rank of an n-rank mesh, at 16x8 pixels of 4boxes with two
bounce levels: the sharded forward render over the BVH (the composable
wavefront over `bvh_closest`) and over brute force agree on the same
rays and draws, and one sharded train step over the albedo gives a
finite loss and finite parameters.  The step trains over the BVH, as
the reference does (over its XLA path, `__graft_entry__.py:98-100`).

    python -m raytracer_tpu_torch.parallel.dryrun --ranks 2 --device cpu
    python -m raytracer_tpu_torch.parallel.dryrun --ranks 1   # one card

`--ranks n` starts n worker processes on localhost (gloo on the CPU,
NCCL on CUDA with one card per rank), waits for them within
`--timeout` seconds and kills any that remain.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from raytracer_tpu_torch.core.engine import TorchDraws
from raytracer_tpu_torch.core.intersectors import (BruteForceIntersector,
                                                   make_intersector)
from raytracer_tpu_torch.diff.inverse import extract_params
from raytracer_tpu_torch.models.collada import ColladaLoader
from raytracer_tpu_torch.parallel.mesh import (all_gather_rays,
                                               initialize_distributed,
                                               make_mesh)
from raytracer_tpu_torch.parallel.render import (make_sharded_render,
                                                 make_sharded_train_step,
                                                 pixel_grid)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
W, H = 16, 8


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Run the checks on this rank of the live n-rank process group (or
    in this process alone when n_devices is 1 and there is none);
    returns the train step's loss.  Raises on any disagreement."""
    mesh = make_mesh(n_devices, device=device)
    scene = ColladaLoader.from_file(os.path.join(_ROOT, "data", "4boxes.dae"),
                                    width=W, height=H, verbose=False)
    buf = scene.to_buffers()
    dev = buf.to_device(mesh.device)
    cam = scene.cameras[0].params(mesh.device)
    isect = make_intersector("bvh", buf, device=mesh.device)
    brute = BruteForceIntersector(chunk=64)
    px, py, _ = pixel_grid(W, H, pad_to=n_devices)

    def draws():
        return TorchDraws(0, mesh.device).split(n_devices)

    with torch.no_grad():
        target = all_gather_rays(mesh, make_sharded_render(
            mesh, isect, W, H, recursions=2)(dev, cam, px, py, draws()))
        target_b = all_gather_rays(mesh, make_sharded_render(
            mesh, brute, W, H, recursions=2)(dev, cam, px, py, draws()))
    assert torch.isfinite(target).all()
    # same rays, same draws: the accel and the oracle agree
    np.testing.assert_allclose(target.cpu().numpy(), target_b.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)

    start = dataclasses.replace(dev, mat_diffuse_rgb=torch.full_like(
        dev.mat_diffuse_rgb, 0.5))
    params = extract_params(start, ("mat_diffuse_rgb",))
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    step = make_sharded_train_step(mesh, isect, W, H, opt, recursions=2)
    loss, params = step(params, start, cam, px, py, target, draws())
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert all(torch.isfinite(v).all() for v in params.values())
    print(f"dryrun_multichip({n_devices}) rank {mesh.rank}: OK (bvh+brute "
          f"agree), loss={loss:.4f}", flush=True)
    return loss


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, device: str, timeout: float) -> int:
    """Start n worker processes of this module and wait for them;
    returns the number that failed."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--worker", str(rank),
         "--port", str(port), "--ranks", str(n), "--device", device,
         "--timeout", str(timeout)], env=env)
        for rank in range(n)]
    failed = 0
    try:
        for p in procs:
            failed += p.wait(timeout=timeout) != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the bring-up and for the whole run")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is None:
        failed = launch(args.ranks, args.device, args.timeout)
        print(f"dryrun: {args.ranks - failed} of {args.ranks} ranks OK")
        return 1 if failed else 0
    initialize_distributed(init_method=f"tcp://127.0.0.1:{args.port}",
                           world_size=args.ranks, rank=args.worker,
                           timeout=args.timeout, device=args.device)
    try:
        dryrun_multichip(args.ranks, device=args.device)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
