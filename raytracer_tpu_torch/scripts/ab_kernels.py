"""Time other versions of csrc/cuda_bvh.cu and csrc/cuda_cluster.cu
against this tree's on one CUDA card, in turns (parent, new, new,
parent) on the same inputs.

    mkdir -p build/parent
    git show HEAD~1:raytracer_tpu_torch/csrc/cuda_bvh.cu \\
        > build/parent/cuda_bvh.cu
    git show HEAD~1:raytracer_tpu_torch/csrc/cuda_cluster.cu \\
        > build/parent/cuda_cluster.cu
    python3 raytracer_tpu_torch/scripts/ab_kernels.py \\
        --bvh build/parent/cuda_bvh.cu \\
        --cluster build/parent/cuda_cluster.cu [--json PATH]

A source left out runs this tree's version in every turn (its spread is
the noise).  A parent must have this tree's C interface for the timed
entry points, except that a cuda_bvh.cu from before the counting entry
(rtx_bvh_tests_needed) may have rtx_bvh_closest's old lanes_out
argument; the entries it lacks are left unbound.  Both builds of a
source use the same nvcc flags (sm_90a, --fmad=false); the ptxas report
of each kernel is printed.  Timed, with CUDA events over 5 launches a
turn: spawn and shadow-shade at each level of one pooled wavefront of
thai2 at 1024x1024 (tpl 256, 8 samples; chip_smoke.py's shapes), and
bvh_closest and cluster_closest at the closest and shadow batches of
levels 0 and 1 of a 1-spp trace_radiance frame (tpl 70).  On the host
clock: the fused render(16) after a render(8) warm-up, the
accel="cluster" render(16) after a render(1) warm-up, and one
trace_radiance frame over the BVH without records (1 sample, 2
bounces) after one warm-up frame.  Needs one card.
"""

import argparse
import contextlib
import json
import os
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TURNS = ("parent", "new", "new", "parent")
REPS = 5


class _Present:
    """A library seen by a setup function: entries the library lacks
    bind to a throwaway namespace instead of raising."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self.lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def parent_setup(name, src):
    """Bind a parent library as this tree's wrappers call it.  A
    cuda_bvh.cu parent with rtx_bvh_closest's lanes_out argument (before
    rtx_bvh_tests_needed) is called through a shim that passes null
    there; the timed calls pass no counter."""
    from raytracer_tpu_torch.ops import cuda_bvh, cuda_cluster
    with open(src) as f:
        text = f.read()
    own = {"cuda_bvh": cuda_bvh, "cuda_cluster": cuda_cluster}[name]
    old_closest = (name == "cuda_bvh" and "lanes_out" in text
                   and "rtx_bvh_tests_needed" not in text)

    def setup(lib):
        own._setup(_Present(lib))
        if not old_closest:
            return
        fn = lib.rtx_bvh_closest
        types_ = list(fn.argtypes)
        fn.argtypes = types_[:-2] + [types_[-3]] + types_[-2:]

        def closest(*args):
            assert args[-3] is None, "the parent's counters are not bound"
            return fn(*args[:-2], None, *args[-2:])
        lib.rtx_bvh_closest = closest
    return setup


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bvh", metavar="SRC",
                    help="the other version of csrc/cuda_bvh.cu")
    ap.add_argument("--cluster", metavar="SRC",
                    help="the other version of csrc/cuda_cluster.cu")
    ap.add_argument("--json", metavar="PATH",
                    help="write every time measured to PATH")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.core.wavefront import trace_radiance
    from raytracer_tpu_torch.ops import cuda_build, cuda_bvh, cuda_cluster

    cs.log(cs.card_line())
    reports = cuda_build.build_all(("cuda_bvh", "cuda_cluster"),
                                   verbose=True)
    parents = {}
    for name, src in (("cuda_bvh", args.bvh), ("cuda_cluster", args.cluster)):
        cs.ptxas_lines(f"new {name}", reports[name])
        if src:
            parents[name], report = cuda_build.load_from(
                name, src, parent_setup(name, src), verbose=True)
            cs.ptxas_lines(f"parent {name}", report)

    def turns(what, fn):
        out = []
        for which in TURNS:
            with contextlib.ExitStack() as stack:
                if which == "parent":
                    for name, lib in parents.items():
                        stack.enter_context(cuda_build.use(name, lib))
                out.append((which, fn()))
        cs.log(f"{what}: " + ", ".join(f"{w} {t:.4f}" for w, t in out))
        return out

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

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
    for what, rays in cs.closest_batches(rt, isect_b):
        lim = 1.0 if what.endswith("shadow") else None
        res[f"bvh_closest {what} ms"] = turns(
            f"bvh_closest {what} ({rays.shape[1]} rays), ms",
            lambda: cs.cuda_ms(lambda: cuda_bvh.bvh_closest(
                rays, isect_b.packed, t_limit=lim, shadow=lim is not None),
                REPS))
        res[f"cluster_closest {what} ms"] = turns(
            f"cluster_closest {what} ({rays.shape[1]} rays), ms",
            lambda: cs.cuda_ms(lambda: cuda_cluster.cluster_closest(
                rays, grid, t_limit=lim), REPS))

    def render(r, spp):
        r.film.clear()
        return host_s(lambda: r.render(spp))
    rt.render(8)                   # warm-up at the timed pool
    res["render(16) s"] = turns("fused render(16) thai2 1024x1024, s",
                                lambda: render(rt, 16))
    rt_c = rtx.create_raytracer_from_file(
        os.path.join(REPO, "data", "thai2.dae"), width=1024, height=1024,
        accel="cluster")
    rt_c.render(1)
    res["cluster render(16) s"] = turns(
        "cluster render(16) thai2 1024x1024, s", lambda: render(rt_c, 16))
    o, d = cs.frame_rays(rt, seed=8)

    def frame():
        return trace_radiance(rt.scene_arrays, o, d,
                              [rtx.TorchDraws(10, "cuda")], isect_b, 2, 1)
    frame()
    res["BVH trace_radiance frame ms"] = turns(
        "BVH trace_radiance frame 1024x1024 1 spp, ms",
        lambda: 1e3 * host_s(frame))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
