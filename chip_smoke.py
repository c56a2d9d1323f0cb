"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py            # the whole check (one card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain only, small
    python3 chip_smoke.py --profile  # the whole check + a kernel profile

Phases (any failure raises and exits non-zero):
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from raytracer_tpu_torch/csrc (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it: the three levels of one real
   pooled wavefront of thai2 (tpl 256, 1024x1024, 8 samples): level 0
   (8,388,608 rays, children b=2), level 1 (16,777,216 rays, b=1) and
   level 2 (16,777,216 rays, b=0), one light; then slices of levels 0
   and 1 for b in {0, 1, 2} and lights L in {1, 2}.  Each kernel and
   plain version is timed at each level, and the kernels count their
   ray-triangle tests for the bound.  Then a whole 64x64 spp-2 render on
   the card against the plain path on the CPU, both fed the same
   numpy-made draws;
4. the main path: thai2 at 1024x1024, render(16) (two pooled wavefronts
   of 8 samples, three levels each) after a render(8) warm-up at the
   same pool and a cleared film, timed, with each kernel's launch count
   and its CUDA-event time per level;
5. one JSON line describing each ported kernel;
6. the last line: {"ok": true, "device": {...}}.

Tolerance of the kernel checks: the kernels are built with --fmad=false,
so they round like the plain versions op for op, and a live ray may
differ in only two ways.  (a) An exact-t tie: the kernel's walk order
picks another triangle at the same t.  Such a ray is counted apart, and
only after a dense test shows that the kernel's record belongs to a
triangle hit at exactly that t.  (b) Slab-test rounding at a box face
culls a hit that the dense version keeps.  At most EDGE_RAYS rays of any
one comparison may differ in any other way (t or any output); the
whole-render check allows 3 * EDGE_RAYS values.

`--json PATH` also writes everything measured to PATH as JSON.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# f32 instructions/s outside the tensor cores: the data sheet's 67 TFLOP/s
# counts an FMA as two flops, and the kernels are built with --fmad=false,
# so each Moller-Trumbore operation is one instruction, at half that rate.
H100_F32_OPS = 33.5e12
EDGE_RAYS = 8                   # see the tolerance above


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class NumpyDraws:
    """Draw source from a seeded numpy generator: the same calls give
    the same numbers on any device."""

    def __init__(self, seed, device):
        import numpy as np
        self.rng = np.random.default_rng(seed)
        self.device = device

    def next_sample(self, n):
        import numpy as np
        import torch
        return (torch.from_numpy(self.rng.random((n, 2), dtype=np.float32))
                .to(self.device), self)

    def normal(self, level, n):
        import numpy as np
        import torch
        return torch.from_numpy(self.rng.standard_normal(
            (n, 3), dtype=np.float32)).to(self.device)


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed(fn):
    """One call timed on the host clock between two synchronizations
    (the plain versions take seconds at full size); returns (result,
    ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def tied(rays, t, krec, bvh, planes):
    """For rays whose kernel record differs from the plain one at the
    same t: True where the kernel's record is that of a triangle that the
    dense test also hits at exactly that t (an exact tie)."""
    import torch
    from raytracer_tpu_torch.ops import cuda_bvh
    out = [torch.zeros((0,), dtype=torch.bool, device=t.device)]
    for s in range(0, t.numel(), 256):
        tt, _, _ = cuda_bvh.mt_plain(rays[:, s:s + 256], bvh.tri)
        at_t = tt == t[s:s + 256, None]
        same = (planes[:, None, :] == krec[:, s:s + 256, None]).all(0)
        out.append((at_t & same).any(1))
    return torch.cat(out)


def check_spawn(what, got, want, rays, b, L, bvh, planes):
    """Compare one spawn launch with its plain version ray by ray; fail
    if more than EDGE_RAYS live rays differ other than by an exact tie.
    The error is the largest |difference| of any float output over the
    live rays that are no tie and hit (or miss) in both versions."""
    import torch
    R = rays.shape[1]
    alive = rays[0].abs() < 1e30
    assert bool((got["t"][~alive] == 3e38).all()), f"{what}: dead ray hit"
    if b:
        live = got["keys"] != 2 ** 30
        assert bool((got["keys"][live] >= 0).all()
                    and (got["keys"][live] < 2 ** 30).all()), \
            f"{what}: live key out of [0, 2^30)"
    t_same = got["t"] == want["t"]
    rec_diff = (got["rec"] != want["rec"]).any(0)
    rest = (got["shadow"] != want["shadow"]).view(6, L, R).any(0).any(0)
    if b:
        rest |= (got["children"] != want["children"]).view(6, R, b).any(0).any(1)
        rest |= (got["keys"] != want["keys"]).view(R, b).any(1)
    ties = torch.zeros_like(alive)
    cand = (alive & t_same & rec_diff & (want["t"] < 3e38)).nonzero()[:, 0]
    if cand.numel():
        ties[cand] = tied(rays[:, cand], want["t"][cand],
                          got["rec"][:, cand], bvh, planes)
    bad = alive & ~ties & (~t_same | rec_diff | rest)
    keep = alive & ~ties & ((got["t"] < 3e38) == (want["t"] < 3e38))
    diffs = [(got["t"] - want["t"]).abs()[keep],
             (got["rec"] - want["rec"]).abs()[:, keep],
             (got["shadow"] - want["shadow"]).abs().view(6, L, R)[:, :, keep]]
    if b:
        diffs.append((got["children"] - want["children"]).abs()
                     .view(6, R, b)[:, keep])
    err = max(float(x.max()) if x.numel() else 0.0 for x in diffs)
    n_bad, n_ties, n_alive = int(bad.sum()), int(ties.sum()), int(alive.sum())
    log(f"spawn {what}: {n_bad} of {n_alive} live rays differ, {n_ties} "
        f"exact-t ties; max |err| {err}")
    assert n_bad <= EDGE_RAYS, f"spawn {what} disagrees"
    return err


def check_shade(what, sk, sp, shadow_rays):
    """Compare one shadow-shade launch with its plain version; fail if
    more than EDGE_RAYS shadow rays differ beyond rtol 1e-6.  The error
    is the largest |difference| over every ray."""
    import torch
    diff = ~torch.isclose(sk, sp, rtol=1e-6, atol=0).all(0)
    n_live = int((shadow_rays[0].abs() < 1e30).sum())
    err = float((sk - sp).abs().max())
    log(f"shadow_shade {what}: {int(diff.sum())} of {n_live} live shadow "
        f"rays differ; max |err| {err}")
    assert int(diff.sum()) <= EDGE_RAYS, f"shadow_shade {what} disagrees"
    return err


def phase_kernels(rt, quick, rec):
    """Kernel vs plain at the main path's shapes; returns the numbers the
    kernels line reports."""
    import numpy as np
    import torch
    from raytracer_tpu_torch.models.camera import generate_rays
    from raytracer_tpu_torch.ops import cuda_bvh

    dev = torch.device("cuda")
    isect = rt.intersector
    scene = rt.scene_arrays
    bvh = isect.packed
    planes = isect.shade_planes
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # level 0 of a real pooled wavefront of the main path: 8 samples of
    # the tile-swizzled frame
    pool = 1 if quick else 8
    px, py = rt._pixels()
    n = px.shape[0] * pool
    jitter = torch.rand((n, 2), generator=gen, device=dev)
    o, d = generate_rays(rt.camera.params(dev), px.repeat(pool),
                         py.repeat(pool), jitter, rt.width, rt.height)
    rays = torch.cat([o.t(), d.t()]).contiguous()
    del o, d, jitter

    lp1, lc1 = scene.light_pos, scene.light_color
    kw = dict(world_lo=isect.world_lo, world_inv_span=isect.world_inv_span,
              emit_uv=False, key_mode="dir6")
    reps = 2 if quick else 5
    bvh_bytes = nbytes(bvh.tri, bvh.seg_aabb, bvh.sc_aabb, bvh.orders)
    res = {k: {"err": 0.0, "levels": []} for k in ("spawn", "shadow_shade")}
    n_slice = 4096 if quick else 32768
    slices = []
    for level, b in enumerate((2, 1, 0)):
        R = rays.shape[1]
        n_live = int((rays[0].abs() < 1e30).sum())
        what = f"level {level} b={b} L=1 ({R} rays)"
        g = torch.randn((3 * b, R), generator=gen, device=dev)
        rows = torch.zeros((R,), dtype=torch.int32, device=dev)
        got = cuda_bvh.bvh_spawn(rays, g, lp1, bvh, planes, children=b,
                                 rows_out=rows, **kw)
        want, p_ms = timed(lambda: cuda_bvh.bvh_spawn_plain(
            rays, g, lp1, bvh, planes, children=b, **kw))
        res["spawn"]["err"] = max(res["spawn"]["err"], check_spawn(
            what, got, want, rays, b, 1, bvh, planes))
        del want
        sh_args = (got["shadow"], got["rec"][0:3], got["rec"][3:6],
                   rays[3:6], lc1)
        rows_sh = torch.zeros((got["shadow"].shape[1],), dtype=torch.int32,
                              device=dev)
        sk = cuda_bvh.bvh_shadow_shade(*sh_args, bvh, rows_out=rows_sh)
        sp, ps_ms = timed(lambda: cuda_bvh.bvh_shadow_shade_plain(*sh_args,
                                                                  bvh))
        res["shadow_shade"]["err"] = max(res["shadow_shade"]["err"],
                                         check_shade(what, sk, sp, sh_args[0]))
        del sk, sp
        k_ms = cuda_ms(lambda: cuda_bvh.bvh_spawn(
            rays, g, lp1, bvh, planes, children=b, **kw), reps)
        ks_ms = cuda_ms(lambda: cuda_bvh.bvh_shadow_shade(*sh_args, bvh),
                        reps)
        sp_bytes = (nbytes(rays, g, lp1, planes) + bvh_bytes
                    + nbytes(*got.values()))
        ss_bytes = nbytes(*sh_args) + bvh_bytes + 3 * sh_args[0].shape[1] * 4
        for name, ms, pms, by, r in (("spawn", k_ms, p_ms, sp_bytes, rows),
                                     ("shadow_shade", ks_ms, ps_ms, ss_bytes,
                                      rows_sh)):
            tests = int(r.sum()) * bvh.C
            ops = tests * cuda_bvh.MT_OPS
            t_bytes = by / H100_BYTES_PER_S * 1e3
            t_ops = ops / H100_F32_OPS * 1e3
            res[name]["levels"].append(dict(
                level=level, rays=int(r.numel()), ms=ms, plain_ms=pms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=by, mt_ops=ops, tests=tests))
            log(f"{name} level {level} ({r.numel()} rays): kernel {ms:.4f} "
                f"ms, plain {pms:.1f} ms, bound {max(t_bytes, t_ops):.6f} ms "
                f"({by} B, {ops} MT ops, {tests / R:.1f} ray-triangle "
                f"tests/ray)")
        # slices for the other children and light counts
        if level == 0:
            slices.append(("level 0", rays[:, R // 2 - n_slice // 2:
                                          R // 2 + n_slice // 2]))
        elif level == 1:
            start = max(0, n_live // 2 - n_slice)
            slices.append(("level 1", rays[:, start:start + 2 * n_slice]))
        if b:
            _, p = torch.sort(got["keys"], stable=True)
            rays = got["children"].index_select(1, p)
        del got, g, sh_args

    rng = np.random.default_rng(1)
    lights = {1: (lp1, lc1),
              2: (torch.cat([lp1, lp1 * torch.tensor([[-1.0, 1.0, 1.0]],
                                                     device=dev)]),
                  torch.cat([lc1, lc1 * 0.35]))}
    for lname, rays in slices:
        rays = rays.contiguous()
        R = rays.shape[1]
        for b in (0, 1, 2):
            for L in (1, 2):
                lp, lc = lights[L]
                what = f"{lname} slice b={b} L={L} ({R} rays)"
                g = torch.from_numpy(rng.standard_normal(
                    (3 * b, R), dtype=np.float32)).to(dev)
                got = cuda_bvh.bvh_spawn(rays, g, lp, bvh, planes,
                                         children=b, **kw)
                want = cuda_bvh.bvh_spawn_plain(rays, g, lp, bvh, planes,
                                                children=b, **kw)
                res["spawn"]["err"] = max(res["spawn"]["err"], check_spawn(
                    what, got, want, rays, b, L, bvh, planes))
                if b == 0:
                    args = (got["shadow"], got["rec"][0:3], got["rec"][3:6],
                            rays[3:6], lc)
                    res["shadow_shade"]["err"] = max(
                        res["shadow_shade"]["err"], check_shade(
                            what, cuda_bvh.bvh_shadow_shade(*args, bvh),
                            cuda_bvh.bvh_shadow_shade_plain(*args, bvh),
                            args[0]))
    # the kernels line reports the largest shape: level 1
    for name in res:
        res[name].update(res[name]["levels"][1])
    rec["kernel_checks"] = res
    return res


def phase_render_compare(rec):
    import numpy as np
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.models.collada import ColladaLoader
    scene = ColladaLoader.from_file(os.path.join(REPO, "data", "thai2.dae"),
                                    width=64, height=64, verbose=False)
    imgs = {}
    for dev in ("cuda", "cpu"):
        rt = rtx.RayTracer(scene, 64, 64, triangles_per_leaf=256, device=dev,
                           draws=NumpyDraws(5, dev))
        t0 = time.perf_counter()
        imgs[dev] = rt.render(2)
        log(f"render 64x64 spp 2 on {dev}: {time.perf_counter() - t0:.2f} s")
    a, b = imgs["cuda"], imgs["cpu"]
    assert np.isfinite(a).all() and a.max() > 0
    flips = int((~np.isclose(a, b, rtol=2e-4, atol=2e-5)).sum())
    log(f"render cuda vs cpu: {flips} of {a.size} values differ; max |err| "
        f"{float(np.abs(a - b).max())}")
    assert flips <= 3 * EDGE_RAYS, "render disagrees with the plain path"
    rec["render_compare"] = dict(flips=flips, values=int(a.size))


def phase_main(rt, rec):
    import numpy as np
    import torch
    from raytracer_tpu_torch.ops import cuda_bvh

    t0 = time.perf_counter()
    rt.render(8)        # one wavefront at the timed render's pool
    torch.cuda.synchronize()
    log(f"warm-up render(8): {time.perf_counter() - t0:.3f} s")
    rt.film.clear()     # the timed render's image holds its 16 samples
    torch.cuda.reset_peak_memory_stats()
    cuda_bvh.bvh_spawn.launches = 0
    cuda_bvh.bvh_shadow_shade.launches = 0
    cuda_bvh.bvh_spawn.events = []
    cuda_bvh.bvh_shadow_shade.events = []
    t0 = time.perf_counter()
    hdr = rt.render(16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"spawn": cuda_bvh.bvh_spawn.launches,
                "shadow_shade": cuda_bvh.bvh_shadow_shade.launches}
    per_launch = {}
    for name, w in (("spawn", cuda_bvh.bvh_spawn),
                    ("shadow_shade", cuda_bvh.bvh_shadow_shade)):
        per_launch[name] = [(a.elapsed_time(b), n) for a, b, n in w.events]
        w.events = None
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in render(16): {launches}")
    assert launches == {"spawn": 6, "shadow_shade": 6}, launches
    assert hdr.shape == (1024, 1024, 3) and np.isfinite(hdr).all()
    nonblack = float((hdr.sum(-1) > 0).mean())
    mrays = 1024 * 1024 * 16 / secs / 1e6
    log(f"render(16) thai2 1024x1024: {secs:.4f} s, {mrays:.4f} primary "
        f"Mrays/s, nonblack {nonblack:.4f}, peak {peak} B allocated")
    for name, lst in per_launch.items():
        for i, (ms, n) in enumerate(lst):
            log(f"  {name} launch {i} (level {i % 3}, {n} rays): {ms:.3f} ms")
    assert nonblack > 0.05, "image is black"
    rec["main"] = dict(seconds=secs, mrays=mrays, nonblack=nonblack,
                       peak_bytes=peak, launches=launches,
                       per_launch=per_launch)
    return launches, per_launch


def phase_profile(rt, rec):
    """torch.profiler over one pooled render(8): device time by kernel
    and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.render(8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    log(f"profile render(8): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f} %)")
    for name, ms, n in kernels[:15]:
        log(f"  {ms:9.3f} ms  {n:4d}x  {name[:100]}")
    rec["profile"] = dict(wall_ms=wall_ms, busy_ms=busy, kernels=kernels[:40])


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and compare the kernels at a small size only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one render(8) by kernel")
    ap.add_argument("--json", metavar="PATH",
                    help="write everything measured to PATH")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "raytracer_tpu_torch")):
        print("chip_smoke: raytracer_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.ops import cuda_bvh

    rec = {}
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    rec["card"] = card

    t0 = time.perf_counter()
    report = cuda_bvh.build(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"built kernels in {build_s:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  " + line.strip())
    rec["build_s"] = build_s

    size = 256 if args.quick else 1024
    rt = rtx.create_raytracer_from_file(
        os.path.join(REPO, "data", "thai2.dae"), width=size, height=size,
        triangles_per_leaf=256)
    checks = phase_kernels(rt, args.quick, rec)
    if args.quick:
        return 0
    phase_render_compare(rec)
    launches, per_launch = phase_main(rt, rec)
    if args.profile:
        phase_profile(rt, rec)

    kernels = []
    for name, replaces in (("spawn", "raytracer_tpu/ops/pallas_bvh.py:985"),
                           ("shadow_shade",
                            "raytracer_tpu/ops/pallas_bvh.py:1068")):
        c = checks[name]
        kernels.append({
            "name": f"bvh_{name}", "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/cuda_bvh.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None, "shape": f"main-path level 1, {c['rays']} rays",
            "levels_ms": [lv["ms"] for lv in c["levels"]],
            "levels_bound_ms": [lv["bound_ms"] for lv in c["levels"]],
            "main_path_ms": [round(ms, 4) for ms, _ in per_launch[name]]})
    line = json.dumps({"kernels": kernels})
    log(line)
    rec["kernels"] = kernels
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
