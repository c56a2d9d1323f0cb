"""Command-line frontend: progressive rendering with per-frame stats
(PyTorch port of ``raytracer_tpu/cli.py``).

    python -m raytracer_tpu_torch.cli -f data/thai2.dae -i 16
    python -m raytracer_tpu_torch.cli -f data/4boxes.dae --device cpu

Capability parity with the reference native frontend
(reference: raytracer/src/main.rs):

- The reference's five flags with the same spellings/defaults
  (main.rs:13-15, 26-100): `-f/--file` (default ./data/thai2.dae),
  `-m/--max_triangles` (default 70), `-i/--frame_iterations` (0 = one
  full pass per --spp), `--width`/`--height` (1024x768).
- Progressive additive render loop printing per-frame fps + primary
  rays/s and the running means on exit (main.rs:194-218, stats prints
  at main.rs:213-216).
- Headless PNG output replaces the minifb window (main.rs:221-253);
  `--serve` starts the live browser viewer.

The JAX package's extras keep their spellings and defaults: `--spp`,
`--bounces`, `--accel`, `--out`, `--compat-v-bug`, `--serve`, `--port`,
`--seed`.  One flag is the port's own: `--device` (default cuda; the
kernels' plain versions run with `--device cpu`).
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="raytracer_tpu_torch",
        description="PyTorch/CUDA progressive ray tracer (raytracer-rs "
                    "parity)")
    p.add_argument("-f", "--file", default="./data/thai2.dae",
                   help="COLLADA scene file (main.rs:30-35)")
    p.add_argument("-m", "--max_triangles", type=int, default=70,
                   help="triangles per accel leaf/cluster (main.rs:36-41)")
    p.add_argument("-i", "--frame_iterations", type=int, default=0,
                   help="stop after N progressive frames; 0 = one full pass "
                        "per --spp (main.rs:42-49)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--spp", type=int, default=1,
                   help="samples per pixel for the default full render")
    p.add_argument("--bounces", type=int, default=2,
                   help="indirect recursion depth (reference RECURSIONS=2)")
    p.add_argument("--accel", choices=["bvh", "cluster", "brute"],
                   default="bvh")
    p.add_argument("--out", default="render.png", help="output PNG path")
    p.add_argument("--compat-v-bug", action="store_true",
                   help="reproduce the reference's idx/height row bug "
                        "(raytracer/mod.rs:96)")
    p.add_argument("--serve", action="store_true",
                   help="serve a live progressive view at localhost:8000 "
                        "(WASM-frontend equivalent)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cpu runs the kernels' "
                        "plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # config echo parity (main.rs:66,72-74)
    print(f"max triangles: {args.max_triangles}")
    if args.frame_iterations:
        print(f"frame iterations: {args.frame_iterations}")

    import torch

    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.utils.png_io import write_png

    rt = rtx.create_raytracer_from_file(
        args.file, triangles_per_leaf=args.max_triangles,
        width=args.width, height=args.height, accel=args.accel,
        recursions=args.bounces, compat_v_bug=args.compat_v_bug,
        seed=args.seed, device=args.device)

    if args.serve:
        from raytracer_tpu_torch.viewer import serve
        return serve(rt, port=args.port,
                     frame_iterations=args.frame_iterations)

    stats = rtx.stats.Stats()
    blocks_per_pass = -(-args.height // rt.rows_per_frame)
    n_frames = args.frame_iterations or blocks_per_pass * args.spp
    for _ in range(n_frames):
        n = rt.trace_frame_additive()
        if rt.device.type == "cuda":
            # a frame's time is its work, not the launches' enqueue
            torch.cuda.synchronize(rt.device)
        print(stats.stats(n))
    print(stats.mean_stats())

    img = rt.get_tonemapped_image()
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
