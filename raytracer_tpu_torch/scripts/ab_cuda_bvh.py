"""Time another version of csrc/cuda_bvh.cu against this tree's on one
CUDA card, in turns (parent, new, new, parent) on the same inputs.

    mkdir -p build/parent
    git show HEAD~1:raytracer_tpu_torch/csrc/cuda_bvh.cu \\
        > build/parent/cuda_bvh.cu
    python3 raytracer_tpu_torch/scripts/ab_cuda_bvh.py \\
        build/parent/cuda_bvh.cu [--json PATH]

The parent source must have this tree's C interface, except that its
rtx_bvh_closest may lack the lanes_out counter.  Both builds use
the same nvcc flags (sm_90a, --fmad=false); the ptxas report of each
kernel is printed.  Timed, with CUDA events over 5 launches a turn:
spawn and shadow-shade at each level of one pooled wavefront of thai2
at 1024x1024 (tpl 256, 8 samples; chip_smoke.py's shapes),
bvh_closest and cluster_closest at the level-1 closest batch of a 1-spp
trace_radiance frame (tpl 70; cluster_closest does not change between
turns, so its spread is the noise), and the fused render(16) on the
host clock after a render(8) warm-up.  Needs one card.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TURNS = ("parent", "new", "new", "parent")
REPS = 5


def parent_setup(src):
    """Bind a parent library as this tree's wrappers call it.  A parent
    whose rtx_bvh_closest has no lanes_out argument (sources before that
    counter) is called through a shim that drops it; the wrappers pass
    lanes_out only when asked to count, which this script never does."""
    from raytracer_tpu_torch.ops import cuda_bvh
    with open(src) as f:
        has_lanes = "lanes_out" in f.read()

    def setup(lib):
        cuda_bvh._setup(lib)
        if has_lanes:
            return
        fn = lib.rtx_bvh_closest
        fn.argtypes = fn.argtypes[:-3] + fn.argtypes[-2:]

        def closest(*args):
            assert args[-3] is None, "the parent cannot count lanes"
            return fn(*args[:-3], *args[-2:])
        lib.rtx_bvh_closest = closest
    return setup


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="the other version of cuda_bvh.cu")
    ap.add_argument("--json", metavar="PATH",
                    help="write every time measured to PATH")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("ab_cuda_bvh: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.ops import cuda_build, cuda_bvh, cuda_cluster

    cs.log(cs.card_line())
    reports = cuda_build.build_all(("cuda_bvh", "cuda_cluster"),
                                   verbose=True)
    parent, parent_report = cuda_build.load_from(
        "cuda_bvh", args.parent, parent_setup(args.parent), verbose=True)
    cs.ptxas_lines("new cuda_bvh", reports["cuda_bvh"])
    cs.ptxas_lines("parent cuda_bvh", parent_report)

    def turns(what, fn):
        out = []
        for which in TURNS:
            if which == "parent":
                with cuda_build.use("cuda_bvh", parent):
                    out.append((which, fn()))
            else:
                out.append((which, fn()))
        cs.log(f"{what}: " + ", ".join(f"{w} {t:.4f}" for w, t in out))
        return out

    res = {}
    rt = rtx.create_raytracer_from_file(
        os.path.join(REPO, "data", "thai2.dae"), width=1024, height=1024,
        triangles_per_leaf=256)
    isect = rt.intersector
    bvh, planes = isect.packed, isect.shade_planes
    lp, lc = rt.scene_arrays.light_pos, rt.scene_arrays.light_color
    kw = cs.spawn_kw(isect)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for level, b, rays, g, got, _ in cs.wavefront_levels(rt, 8, gen):
        sh_args = cs.shade_args(got, rays, lc)
        res[f"spawn level {level} ms"] = turns(
            f"spawn level {level} ({rays.shape[1]} rays), ms",
            lambda: cs.cuda_ms(lambda: cuda_bvh.bvh_spawn(
                rays, g, lp, bvh, planes, children=b, **kw), REPS))
        res[f"shadow_shade level {level} ms"] = turns(
            f"shadow_shade level {level} ({sh_args[0].shape[1]} rays), ms",
            lambda: cs.cuda_ms(lambda: cuda_bvh.bvh_shadow_shade(
                *sh_args, bvh), REPS))
        del sh_args

    isect_b = rtx.make_intersector("bvh", rt.scene_buffers)
    grid = rtx.make_intersector("cluster", rt.scene_buffers).packed
    what, rays = cs.closest_batches(rt, isect_b)[2]
    res["bvh_closest ms"] = turns(
        f"bvh_closest {what} ({rays.shape[1]} rays), ms",
        lambda: cs.cuda_ms(lambda: cuda_bvh.bvh_closest(
            rays, isect_b.packed), REPS))
    res["cluster_closest ms"] = turns(
        f"cluster_closest {what} ({rays.shape[1]} rays), ms",
        lambda: cs.cuda_ms(lambda: cuda_cluster.cluster_closest(
            rays, grid), REPS))

    def render():
        rt.film.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.render(16)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    rt.render(8)                   # warm-up at the timed pool
    res["render(16) s"] = turns("fused render(16) thai2 1024x1024, s",
                                render)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
