"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py            # the whole check (one card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain only, small
    python3 chip_smoke.py --profile  # + kernel profiles of two renders,
                                     # a CLI frame and two inverse steps

Phases (any failure raises and exits non-zero):
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from raytracer_tpu_torch/csrc (one nvcc per
   source, all started together, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it.  The fused kernels (bvh_spawn,
   bvh_shadow_shade): the three levels of one real pooled wavefront of
   thai2 (tpl 256, 1024x1024, 8 samples): level 0 (8,388,608 rays,
   children b=2), level 1 (16,777,216 rays, b=1) and level 2
   (16,777,216 rays, b=0), one light; then slices of levels 0 and 1 for
   b in {0, 1, 2} and lights L in {1, 2}.  The closest-hit kernels
   (bvh_closest, cluster_closest, tpl 70): the closest and shadow
   batches of levels 0 (1,048,576 rays) and 1 (2,097,152 rays, dead rays
   sorted last) of one 1-spp trace_radiance wavefront of thai2 at
   1024x1024; bvh_closest also on level-0 slices with 6 and 7 record
   planes and with a t limit, both on a slice of axis-parallel rays, and
   cluster_closest on a tpl-256 grid (C = 256) at the level-1 closest
   batch.  Each kernel and plain version is timed at each shape.  The
   bound of every kernel counts the ray-triangle tests its inputs need,
   from a per-ray counting walk on the same rays at the same t limit
   (BIG_T, or 1.0 for shadow rays), so a kernel that tests more does not
   raise its own bound: for the BVH kernels the lanes of the segments
   that bvh_tests_needed's walk enters before each ray's best t, for the
   cluster kernel C lanes per cluster that cluster_tests_needed's walk
   enters.  Beside it stand the bound from the BVH walk's whole rows (the
   first slice's yardstick) and the tests each kernel ran itself (its own
   counter, tests_out).  Then whole 64x64 renders on the card against the
   plain path on the CPU, both fed the same numpy-made draws: the fused
   path (spp 2) and accel="cluster" (spp 1);
4. the main paths, each with every launch count set to 0 just before
   it and read just after:
   a. the fused BVH render: thai2 at 1024x1024, render(16) (two pooled
      wavefronts of 8 samples, three levels each) after a render(8)
      warm-up at the same pool and a cleared film;
   b. accel="cluster": thai2 at 1024x1024 (tpl 70: 157 clusters of 128),
      render(16) after a render(1) warm-up and a cleared film, one
      sample per wavefront (96 cluster_closest launches); render(4)
      instead when the warm-up shows render(16) would pass 60 s;
   c. the composable wavefront over the BVH with no records (what
      __graft_entry__.entry() runs), thai2 1024x1024, 1 sample,
      recursions 2: 6 bvh_closest launches;
   each timed, with each kernel's launch count and CUDA-event times;
   d. the compact "mat" records: spawn with 4 record planes against its
      plain version at levels 0 and 1 of a pooled thai2 1024x1024
      wavefront (tpl 256), timed beside the 6 "full" planes; render(16)
      of thai2 1024x1024 in turns (full, mat, mat, full) from the same
      draws, 0 differing film values and launches 6 + 6; ico3_tex
      (textured) at 256x256, 2 spp, "mat" against "full", 0 differing;
   e. the CLI (`cli.main`) at its defaults on thai2 (1024x768, -m 70, 2
      bounces) for one progressive pass of 16 frames: its prints, launch
      counts (3 levels a frame: 48 + 48) and a PNG that decodes to
      768x1024x3; then `--accel cluster -i 2` (12 launches);
   f. inverse rendering of ico3_tex at 1024x1024, 1 spp, 2 bounces,
      brute force on the card: 3 Adam steps over albedo and vertices
      (loss falling, seconds per step, peak memory, no kernel launch);
      the first step's gradients at 64x64 on the card against the CPU
      (the CPU tests' tolerance); the fused path under autograd raises;
      the gather backward's launches (`gather_rows.launches`: 6 a step);
   g. the viewer over create_inline_raytracer (1024x768) on a free
      local port: 3 frames, /frame.png decodes, /stats, /key/w clears
      the film, then shut down;
   h. multi-device rendering over NCCL at world size 1 (one card):
      initialize_distributed (tcp on a free local port) returns True,
      again True, and make_mesh() has one rank; render_sharded(16) of
      thai2 at 1024x1024 (fused BVH, pool 8, the row-major pixel_grid
      order) after a render_sharded(8) warm-up and a cleared film, its
      launches (6 + 6) and per-level kernel times beside phase a's (16x8
      tiles), and render(16) in turns (render, sharded, sharded,
      render); render_sharded of ico3_tex (textured, tpl 70) at 64x64,
      spp 2, on the card against the CPU from the same numpy-made
      per-rank draws (at most 3 * EDGE_RAYS values differ); the sharded
      train step (4boxes 64x64, brute force, 2 bounces, 3 Adam steps over
      the albedo: loss falling, no kernel launch, the first step equal to
      the unsharded diff.inverse step within rtol 1e-5); the process
      group is destroyed whatever happens;
   i. gradients over the kernel intersectors: scene_grads of ico3_tex at
      64x64 (2 bounces) over the BVH and the cluster grid on the card
      against the CPU (every float leaf, the CPU tests' rule), the
      radiance under autograd equal bit for bit to the no_grad one, the
      hit rays whose recomputed t differs from the kernel's; fwd+bwd of
      thai2 at 1024x1024 (1 spp, 2 bounces) over the BVH without records
      (tpl 70): seconds a step (median of 3 after a warm-up), Mrays/s,
      peak memory, 6 bvh_closest launches a step, the forward-only frame
      and a profile of one step; phase f's inverse step over a BVH built
      from the start's vertices beside brute force's (the first losses
      within 1e-4); the dry run (`parallel/dryrun.py --ranks 1`) over
      NCCL, training over the BVH.  Each step's launches of the gather
      backward (ops/cuda_gather.py) are counted, and the inputs of one
      thai2 step and of one inverse step are kept: each call is run again
      through
      the kernel and held per row against the float64 plain sum, within
      `sum_depth` x 2^-24 x the row's sum of |values|, and timed beside
      the library's index_put_ (PyTorch's backward of `table[idx]`) and
      index_add_ on the same inputs;
5. one JSON line describing each ported kernel;
6. the last line: {"ok": true, "device": {...}}.

raytracer_tpu_torch/scripts/ab_kernels.py times other versions of
csrc/cuda_bvh.cu and csrc/cuda_cluster.cu against this tree's on the
same inputs.

Tolerance of the kernel checks: the kernels are built with --fmad=false,
so they round like the plain versions op for op, and a live ray may
differ in only two ways.  (a) An exact-t tie: the kernel's walk order
picks another triangle at the same t.  Such a ray is counted apart, and
only after a dense test shows that the kernel's triangle is hit at
exactly that t.  (b) Slab-test rounding at a box face culls a hit that
the dense version keeps.  At most EDGE_RAYS rays of any one comparison
may differ in any other way (t or any output); the whole-render checks
allow 3 * EDGE_RAYS values.

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

    def split(self, n):
        """n sources seeded from this one (one per rank)."""
        return [NumpyDraws(int(s), self.device)
                for s in self.rng.integers(0, 2 ** 62, size=n)]


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


BIG_T = 3.0e38


def kernel_wrappers():
    """Every ported kernel's wrapper by name; each keeps `launches` (a
    count that only a kernel launch raises) and `events`."""
    from raytracer_tpu_torch.ops import cuda_bvh, cuda_cluster
    return {"bvh_spawn": cuda_bvh.bvh_spawn,
            "bvh_shadow_shade": cuda_bvh.bvh_shadow_shade,
            "bvh_closest": cuda_bvh.bvh_closest,
            "cluster_closest": cuda_cluster.cluster_closest}


GATHER_KEY = "gather_rows.launches"
_gather_base = {}


def set_counts(timing):
    """Every kernel's launch count to 0; with `timing`, each launch also
    records CUDA events (else none).  The gather backward's counters are
    the program's own, so `gather_counts` reads them from here on."""
    from raytracer_tpu_torch.utils import profiling
    for w in kernel_wrappers().values():
        w.launches = 0
        w.events = [] if timing else None
    _gather_base[GATHER_KEY] = profiling.counters()[GATHER_KEY]


def gather_counts():
    """Launches of the gather backward's kernel since the last
    `set_counts`."""
    from raytracer_tpu_torch.utils import profiling
    return profiling.counters()[GATHER_KEY] - _gather_base[GATHER_KEY]


def gather_capture(fn, limit):
    """fn(), with the inputs (grad, idx, n) of its first `limit` calls of
    the gather backward kept (clones, on the card)."""
    from raytracer_tpu_torch.ops import cuda_gather
    kept, backward = [], cuda_gather.rows_backward

    def keep(grad, idx, n):
        if len(kept) < limit:
            kept.append((grad.clone(), idx.clone(), n))
        return backward(grad, idx, n)
    cuda_gather.rows_backward = keep
    try:
        out = fn()
    finally:
        cuda_gather.rows_backward = backward
    return out, kept


def check_gather(what, kept):
    """Each kept call of the gather backward run again through the kernel
    and held per row against the float64 plain sum, within
    `cuda_gather.sum_depth` x 2^-24 x the row's sum of |values| (Higham's
    bound for a float32 sum that deep in any order); its time beside the
    library's on the same inputs: index_put_ with accumulate (PyTorch's
    backward of `table[idx]`) and index_add_; and the bound by bytes,
    M x (4 C + 8) B at HBM3's rate.  Returns one record a call."""
    import torch
    from raytracer_tpu_torch.ops import cuda_gather
    out = []
    for grad, idx, n in kept:
        m, c = grad.shape
        got = cuda_gather.rows_backward(grad, idx, n).cpu().double()
        g64, i64 = grad.cpu().double(), idx.cpu()
        exact = cuda_gather.rows_backward_plain(g64, i64, n)
        scale = cuda_gather.rows_backward_plain(g64.abs(), i64, n)
        k = torch.bincount(i64, minlength=n)
        depth = cuda_gather.sum_depth(k, m)
        bound_err = depth[:, None] * 2.0 ** -24 * scale
        err = (got - exact).abs()
        over = float((err / bound_err.clamp(min=1e-300)).max())
        ms = cuda_ms(lambda: cuda_gather.rows_backward(grad, idx, n), 10)
        zeros = lambda: torch.zeros((n, c), device=grad.device)  # noqa: E731
        add_ms = cuda_ms(lambda: zeros().index_add_(0, idx, grad), 3)
        put_ms = cuda_ms(lambda: zeros().index_put_((idx,), grad,
                                                    accumulate=True), 1)
        bound_ms = m * (4 * c + 8) / H100_BYTES_PER_S * 1e3
        r = dict(rows=m, table=(n, c),
                 hot_share=float(k.max()) / max(m, 1), ms=ms,
                 bound_ms=bound_ms, index_put_ms=put_ms, index_add_ms=add_ms,
                 max_abs_err=float(err.max()), err_over_bound=over)
        log(f"{what} gather backward ({n}, {c}) <- {m} rows "
            f"(hot row {100 * r['hot_share']:.1f} %): {ms:.4f} ms (bound "
            f"{bound_ms:.4f} ms by bytes; index_put_ {put_ms:.3f} ms, "
            f"index_add_ {add_ms:.4f} ms); max |err| "
            f"{r['max_abs_err']:.3g}, error / depth bound {over:.3g}")
        assert over <= 1.0, (what, r)
        out.append(r)
    return out


def read_counts():
    """The launch counts, and the (ms, rays) of each timed launch."""
    import torch
    torch.cuda.synchronize()
    counts, times = {}, {}
    for name, w in kernel_wrappers().items():
        counts[name] = w.launches
        times[name] = [(a.elapsed_time(b), n) for a, b, n in (w.events or [])]
        w.events = None
    return counts, times


def ptxas_lines(name, report):
    """The per-kernel lines of a -Xptxas -v report: entry, registers,
    shared memory, spills."""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            log(f"  {name}: " + line.split("'")[1][:60])
        elif ("registers" in line or "spill" in line
              or "error" in line.lower()):
            log(f"  {name}:   " + line.strip())


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


def bound(nbytes_moved, tests):
    """(bound_ms, bound_by) of a kernel that must move `nbytes_moved`
    bytes and run `tests` Moller-Trumbore tests."""
    from raytracer_tpu_torch.ops.cuda_bvh import MT_OPS
    t_bytes = nbytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = tests * MT_OPS / H100_F32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bvh_needed(rays, bvh, limit):
    """(tests needed, whole-row tests) of `rays` on the BVH at `limit`,
    from the per-ray counting walk: the lanes of the segments it enters
    before each ray's best t, and its rows x C."""
    from raytracer_tpu_torch.ops import cuda_bvh
    n = cuda_bvh.bvh_tests_needed(rays, bvh, t_limit=limit)
    return int(n["lanes"].sum()), int(n["rows"].sum()) * bvh.C


def cluster_needed(rays, grid, limit):
    """(tests needed, the same) of `rays` on the cluster grid at `limit`:
    C lanes per cluster the per-ray counting walk enters."""
    from raytracer_tpu_torch.ops import cuda_cluster
    n = cuda_cluster.cluster_tests_needed(rays, grid, t_limit=limit)
    tests = int(n["clusters"].sum()) * grid.C
    return tests, tests


def f32_share(tests_run, ms):
    """The share of the card's f32 instruction rate that `tests_run`
    Moller-Trumbore tests in `ms` milliseconds take."""
    from raytracer_tpu_torch.ops.cuda_bvh import MT_OPS
    return tests_run * MT_OPS / (ms * 1e-3) / H100_F32_OPS


def spawn_kw(isect):
    return dict(world_lo=isect.world_lo, world_inv_span=isect.world_inv_span,
                emit_uv=False, key_mode="dir6")


def wavefront_levels(rt, pool, gen):
    """The three levels of one pooled wavefront of rt's frame, the main
    path's shapes: yields (level, b, rays, gauss, got, run), `got` the
    spawn kernel's outputs on those rays and `run` its per-ray test
    counter.  Level 0 is `pool` jittered samples of the tile-swizzled
    frame; each next level is got's children sorted by key, as the
    engine sorts them.  Draws come from the CUDA generator `gen`."""
    import torch
    from raytracer_tpu_torch.models.camera import generate_rays
    from raytracer_tpu_torch.ops import cuda_bvh
    dev = torch.device("cuda")
    isect = rt.intersector
    px, py = rt._pixels()
    jitter = torch.rand((px.shape[0] * pool, 2), generator=gen, device=dev)
    o, d = generate_rays(rt.camera.params(dev), px.repeat(pool),
                         py.repeat(pool), jitter, rt.width, rt.height)
    rays = torch.cat([o.t(), d.t()]).contiguous()
    del o, d, jitter
    for level, b in enumerate((2, 1, 0)):
        R = rays.shape[1]
        g = torch.randn((3 * b, R), generator=gen, device=dev)
        run = torch.zeros((R,), dtype=torch.int32, device=dev)
        got = cuda_bvh.bvh_spawn(rays, g, rt.scene_arrays.light_pos,
                                 isect.packed, isect.shade_planes,
                                 children=b, tests_out=run,
                                 **spawn_kw(isect))
        yield level, b, rays, g, got, run
        if b:
            _, p = torch.sort(got["keys"], stable=True)
            rays = got["children"].index_select(1, p)


def shade_args(got, rays, light_color):
    """bvh_shadow_shade's operands after a spawn launch `got` on `rays`."""
    return (got["shadow"], got["rec"][0:3], got["rec"][3:6], rays[3:6],
            light_color)


def phase_kernels(rt, quick, rec):
    """Kernel vs plain at the main path's shapes; returns the numbers the
    kernels line reports."""
    import numpy as np
    import torch
    from raytracer_tpu_torch.ops import cuda_bvh

    dev = torch.device("cuda")
    isect = rt.intersector
    scene = rt.scene_arrays
    bvh = isect.packed
    planes = isect.shade_planes
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lp1, lc1 = scene.light_pos, scene.light_color
    kw = spawn_kw(isect)
    reps = 2 if quick else 5
    bvh_bytes = nbytes(bvh.tri, bvh.seg_aabb, bvh.sc_aabb, bvh.orders)
    res = {k: {"err": 0.0, "levels": []} for k in ("spawn", "shadow_shade")}
    n_slice = 4096 if quick else 32768
    slices = []
    for level, b, rays, g, got, run in wavefront_levels(rt, 1 if quick else 8,
                                                        gen):
        R = rays.shape[1]
        n_live = int((rays[0].abs() < 1e30).sum())
        what = f"level {level} b={b} L=1 ({R} rays)"
        want, p_ms = timed(lambda: cuda_bvh.bvh_spawn_plain(
            rays, g, lp1, bvh, planes, children=b, **kw))
        res["spawn"]["err"] = max(res["spawn"]["err"], check_spawn(
            what, got, want, rays, b, 1, bvh, planes))
        del want
        sh_args = shade_args(got, rays, lc1)
        run_sh = torch.zeros((got["shadow"].shape[1],), dtype=torch.int32,
                             device=dev)
        sk = cuda_bvh.bvh_shadow_shade(*sh_args, bvh, tests_out=run_sh)
        sp, ps_ms = timed(lambda: cuda_bvh.bvh_shadow_shade_plain(*sh_args,
                                                                  bvh))
        res["shadow_shade"]["err"] = max(res["shadow_shade"]["err"],
                                         check_shade(what, sk, sp, sh_args[0]))
        del sk, sp
        # the tests needed: the per-ray counting walk on the same rays at
        # the same t limit
        need = {"spawn": bvh_needed(rays, bvh, BIG_T),
                "shadow_shade": bvh_needed(sh_args[0], bvh, 1.0)}
        k_ms = cuda_ms(lambda: cuda_bvh.bvh_spawn(
            rays, g, lp1, bvh, planes, children=b, **kw), reps)
        ks_ms = cuda_ms(lambda: cuda_bvh.bvh_shadow_shade(*sh_args, bvh),
                        reps)
        sp_bytes = (nbytes(rays, g, lp1, planes) + bvh_bytes
                    + nbytes(*got.values()))
        ss_bytes = nbytes(*sh_args) + bvh_bytes + 3 * sh_args[0].shape[1] * 4
        for name, ms, pms, by, r in (
                ("spawn", k_ms, p_ms, sp_bytes, run),
                ("shadow_shade", ks_ms, ps_ms, ss_bytes, run_sh)):
            n = r.numel()
            tests, tests_rows = need[name]
            tests_run = int(r.sum())       # lanes the kernel's warps tested
            b_ms, b_by = bound(by, tests)
            rb_ms, _ = bound(by, tests_rows)
            res[name]["levels"].append(dict(
                level=level, rays=n, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, bound_rows_ms=rb_ms, bytes=by,
                mt_ops=tests * cuda_bvh.MT_OPS, tests=tests,
                tests_rows=tests_rows, tests_run=tests_run))
            log(f"{name} level {level} ({n} rays): kernel {ms:.4f} ms "
                f"({100 * b_ms / ms:.1f} % of bound), plain {pms:.1f} ms, "
                f"bound {b_ms:.6f} ms ({by} B, {tests * cuda_bvh.MT_OPS} MT "
                f"ops), row bound {rb_ms:.6f} ms ({100 * rb_ms / ms:.1f} %); "
                f"tests/ray needed {tests / n:.2f} (rows: "
                f"{tests_rows / n:.2f}), run {tests_run / n:.2f} (x"
                f"{tests_run / max(tests, 1):.3f})")
        # slices for the other children and light counts
        if level == 0:
            slices.append(("level 0", rays[:, R // 2 - n_slice // 2:
                                          R // 2 + n_slice // 2]))
        elif level == 1:
            start = max(0, n_live // 2 - n_slice)
            slices.append(("level 1", rays[:, start:start + 2 * n_slice]))
        del g, sh_args, run_sh

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
                    args = shade_args(got, rays, lc)
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

    t0 = time.perf_counter()
    rt.render(8)        # one wavefront at the timed render's pool
    torch.cuda.synchronize()
    log(f"warm-up render(8): {time.perf_counter() - t0:.3f} s")
    rt.film.clear()     # the timed render's image holds its 16 samples
    torch.cuda.reset_peak_memory_stats()
    set_counts(timing=True)
    t0 = time.perf_counter()
    hdr = rt.render(16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, times = read_counts()
    launches = {"spawn": counts["bvh_spawn"],
                "shadow_shade": counts["bvh_shadow_shade"]}
    per_launch = {"spawn": times["bvh_spawn"],
                  "shadow_shade": times["bvh_shadow_shade"]}
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in render(16): {counts}")
    assert counts == {"bvh_spawn": 6, "bvh_shadow_shade": 6,
                      "bvh_closest": 0, "cluster_closest": 0}, counts
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


class Recorder:
    """An intersector that records the plane-form rays of every closest
    and shadow query, then hands the query on."""

    def __init__(self, isect):
        self.isect = isect
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.isect, name)

    def query(self, scene, origins, dirs, alive=None, **kw):
        from raytracer_tpu_torch.ops.cuda_bvh import rays_from
        self.calls.append(("closest", rays_from(origins, dirs, alive)))
        return self.isect.query(scene, origins, dirs, alive=alive, **kw)

    def shadow(self, scene, origins, dirs, alive=None, **kw):
        from raytracer_tpu_torch.ops.cuda_bvh import rays_from
        self.calls.append(("shadow", rays_from(origins, dirs, alive)))
        return self.isect.shadow(scene, origins, dirs, alive=alive, **kw)


def frame_rays(rt, seed):
    """Primary rays of one jittered sample of rt's whole frame, in the
    engine's tile-swizzled order."""
    import torch
    from raytracer_tpu_torch.models.camera import generate_rays
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    px, py = rt._pixels()
    jitter = torch.rand((px.shape[0], 2), generator=gen, device=dev)
    return generate_rays(rt.camera.params(dev), px, py, jitter, rt.width,
                         rt.height)


def mt_tie(rays, t, slot, tri):
    """True where the dense Moller-Trumbore of each ray against the
    triangle at its kernel slot gives exactly t (an exact-t tie)."""
    from raytracer_tpu_torch.core.intersect import moller_trumbore
    cols = tri[:, slot.long().clamp(min=0)]
    return moller_trumbore(*rays.unbind(0), *cols.unbind(0))[0] == t


def check_closest(what, got, want, rays, tri, limit, shadow):
    """Compare one closest-hit launch with its plain version ray by ray.
    Below `limit` every output must match; beyond it t is unspecified
    (the walk may cull), but no kernel t may undercut the dense one.
    Shadow batches compare the (0.01, 1.0) window and t below the
    limit.  Fails if more than EDGE_RAYS live rays differ other than by
    an exact tie; returns the largest |difference| of a float output
    over the live rays that are no tie and hit (or miss) in both."""
    import torch
    alive = rays[0].abs() < 1e30
    assert bool((got["t"][~alive] == BIG_T).all()), f"{what}: dead ray hit"
    below = want["t"] < limit
    bad = alive & (got["t"] < want["t"])
    ties = torch.zeros_like(alive)
    if shadow:
        def window(t):
            return (t < BIG_T) & (t > 0.01) & (t < 1.0)
        bad |= alive & ((window(got["t"]) != window(want["t"]))
                        | (below & (got["t"] != want["t"])))
        keep = alive & below & (got["t"] < BIG_T)
        fields = ("t",)
    else:
        fields = ("t", "u", "v") + (("rec",) if "rec" in want else ())
        diff = got["slot"] != want["slot"]
        for k in fields:
            d = got[k] != want[k]
            diff |= d.any(0) if d.dim() == 2 else d
        cand = (alive & below & (got["t"] == want["t"]) & (want["t"] < BIG_T)
                & (got["slot"] != want["slot"])).nonzero()[:, 0]
        if cand.numel():
            ties[cand] = mt_tie(rays[:, cand], want["t"][cand],
                                got["slot"][cand], tri)
        bad |= alive & below & ~ties & diff
        keep = alive & below & ~ties & ((got["t"] < BIG_T)
                                        == (want["t"] < BIG_T))
    err = 0.0
    for k in fields:
        dk = (got[k] - want[k]).abs()
        dk = dk[:, keep] if dk.dim() == 2 else dk[keep]
        if dk.numel():
            err = max(err, float(dk.max()))
    n_bad, n_ties, n_alive = int(bad.sum()), int(ties.sum()), int(alive.sum())
    log(f"{what}: {n_bad} of {n_alive} live rays differ, {n_ties} exact-t "
        f"ties; max |err| {err}")
    assert n_bad <= EDGE_RAYS, f"{what} disagrees"
    return err


def axis_parallel_rays(grid, n, seed):
    """(6, n) rays with one nonzero direction component (+-1), origins
    inside the scene bounds, a quarter of them exactly on a plane of a
    cluster box parallel to the ray (a zero component meets an origin on
    the plane: the cluster kernel's raw 1/d gives NaN there)."""
    import torch
    dev = grid.aabb.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lo = grid.aabb[:, 0:3].min(0).values
    hi = grid.aabb[:, 3:6].max(0).values
    o = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    axis = torch.randint(0, 3, (n,), generator=gen, device=dev)
    sign = torch.randint(0, 2, (n,), generator=gen, device=dev) * 2.0 - 1.0
    d = torch.zeros((n, 3), device=dev)
    d[torch.arange(n, device=dev), axis] = sign
    snap = torch.arange(0, n, 4, device=dev)
    k = torch.randint(0, grid.num_clusters, (snap.numel(),), generator=gen,
                      device=dev)
    c = (axis[snap] + torch.randint(1, 3, (snap.numel(),), generator=gen,
                                    device=dev)) % 3
    side = torch.randint(0, 2, (snap.numel(),), generator=gen, device=dev)
    o[snap, c] = grid.aabb[k, 3 * side + c]
    return torch.cat([o.t(), d.t()]).contiguous()


def closest_batches(rt, isect):
    """The closest and shadow batches of levels 0 and 1 of one 1-spp
    trace_radiance wavefront of rt's frame over `isect` (entry()'s
    path): [(name, (6, R) rays)]."""
    from raytracer_tpu_torch.core.engine import TorchStream
    from raytracer_tpu_torch.core.wavefront import trace_radiance
    o, d = frame_rays(rt, seed=2)
    recorder = Recorder(isect)
    trace_radiance(rt.scene_arrays, o, d, [TorchStream(3, "cuda")],
                   recorder, 2, 1)
    return [(f"level {i // 2} {kind}", rays) for i, (kind, rays)
            in enumerate(recorder.calls[:4])]


def phase_closest_kernels(rt, quick, rec):
    """bvh_closest and cluster_closest against their plain versions at
    the level shapes of one 1-spp trace_radiance wavefront (tpl 70)."""
    import torch
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.core.shade import build_slot_records
    from raytracer_tpu_torch.ops import cuda_bvh, cuda_cluster

    scene = rt.scene_arrays
    isect_b = rtx.make_intersector("bvh", rt.scene_buffers)
    isect_c = rtx.make_intersector("cluster", rt.scene_buffers)
    bvh, grid = isect_b.packed, isect_c.packed
    log(f"closest-hit structures: BVH {bvh.num_slots} slots (C={bvh.C}), "
        f"cluster grid K={grid.num_clusters} C={grid.C}")
    batches = closest_batches(rt, isect_b)
    reps = 2 if quick else 5
    # each kernel's call (tests: its per-ray tests run), plain version,
    # counting walk, triangle planes and structure bytes
    kernels = {
        "bvh_closest": (
            lambda r, lim, sh, tests=None: cuda_bvh.bvh_closest(
                r, bvh, t_limit=lim, shadow=sh, tests_out=tests),
            lambda r, sh: cuda_bvh.bvh_closest_plain(r, bvh, shadow=sh),
            lambda r, lim: bvh_needed(r, bvh, lim), bvh.tri,
            bvh.num_slots * 36 + (bvh.seg_aabb.numel() + bvh.sc_aabb.numel()
                                  + bvh.orders.numel()) * 4),
        "cluster_closest": (
            lambda r, lim, sh, tests=None: cuda_cluster.cluster_closest(
                r, grid, t_limit=lim, tests_out=tests),
            lambda r, sh: cuda_cluster.cluster_closest_plain(r, grid),
            lambda r, lim: cluster_needed(r, grid, lim), grid.tri,
            grid.num_slots * 36 + (grid.aabb.numel()
                                   + grid.orders.numel()) * 4)}
    res = {k: {"err": 0.0, "levels": []} for k in kernels}
    for name, (kern, plain, needed, tri, struct_bytes) in kernels.items():
        for what, rays in batches:
            shadow = what.endswith("shadow")
            lim = 1.0 if shadow else BIG_T
            R = rays.shape[1]
            run = torch.zeros((R,), dtype=torch.int32, device=rays.device)
            got = kern(rays, lim, shadow, run)
            want, p_ms = timed(lambda: plain(rays, shadow))
            res[name]["err"] = max(res[name]["err"], check_closest(
                f"{name} {what} ({R} rays)", got, want, rays, tri, lim,
                shadow))
            del got, want
            k_ms = cuda_ms(lambda: kern(rays, lim, shadow), reps)
            by = nbytes(rays) + struct_bytes + (4 if shadow else 16) * R
            tests, tests_rows = needed(rays, lim)
            tests_run = int(run.sum())
            b_ms, b_by = bound(by, tests)
            rb_ms, _ = bound(by, tests_rows)
            rate = f32_share(tests_run, k_ms)
            res[name]["levels"].append(dict(
                batch=what, rays=R, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, bound_rows_ms=rb_ms, bytes=by,
                mt_ops=tests * cuda_bvh.MT_OPS, tests=tests,
                tests_rows=tests_rows, tests_run=tests_run, f32_share=rate))
            log(f"{name} {what} ({R} rays): kernel {k_ms:.4f} ms "
                f"({100 * b_ms / k_ms:.1f} % of bound), plain {p_ms:.1f} ms, "
                f"bound {b_ms:.6f} ms ({by} B, {tests * cuda_bvh.MT_OPS} MT "
                f"ops), row bound {rb_ms:.6f} ms; tests/ray needed "
                f"{tests / R:.2f} (rows: {tests_rows / R:.2f}), run "
                f"{tests_run / R:.2f} (x{tests_run / max(tests, 1):.3f}); "
                f"tests run at {100 * rate:.1f} % of the f32 rate")
            del run
        # the kernels line reports the largest shape: level 1 closest
        res[name].update(res[name]["levels"][2])

    # slices: records, a t limit, axis-parallel rays
    n_slice = 4096 if quick else 65536
    lvl0 = batches[0][1]
    mid = lvl0.shape[1] // 2
    sl = lvl0[:, mid - n_slice // 2:mid + n_slice // 2].contiguous()
    records = build_slot_records(scene, isect_b.perm, bvh.num_slots)
    for n_rec in (6, 7):
        planes = records[:, :n_rec].t().contiguous()
        got = cuda_bvh.bvh_closest(sl, bvh, planes)
        want = cuda_bvh.bvh_closest_plain(sl, bvh, planes)
        res["bvh_closest"]["err"] = max(res["bvh_closest"]["err"],
                                        check_closest(
            f"bvh_closest level 0 slice, {n_rec} record planes "
            f"({n_slice} rays)", got, want, sl, bvh.tri, BIG_T, False))
    want = cuda_bvh.bvh_closest_plain(sl, bvh)
    hit_t = want["t"][want["t"] < BIG_T]
    lim = float(hit_t.median()) if hit_t.numel() else 1.0
    got = cuda_bvh.bvh_closest(sl, bvh, t_limit=lim)
    res["bvh_closest"]["err"] = max(res["bvh_closest"]["err"], check_closest(
        f"bvh_closest level 0 slice, t_limit {lim:.4f} ({n_slice} rays)",
        got, want, sl, bvh.tri, lim, False))
    ax = axis_parallel_rays(grid, n_slice, seed=4)
    for name, (kern, plain, _, tri, _) in kernels.items():
        for shadow in (False, True):
            lim = 1.0 if shadow else BIG_T
            res[name]["err"] = max(res[name]["err"], check_closest(
                f"{name} axis-parallel slice{' shadow' if shadow else ''} "
                f"({n_slice} rays)", kern(ax, lim, shadow), plain(ax, shadow),
                ax, tri, lim, shadow))
    # the cluster kernel at C = 256 lanes a cluster (two staged chunks)
    grid256 = rtx.make_intersector("cluster", rt.scene_buffers,
                                   triangles_per_leaf=256).packed
    assert grid256.C == 256, grid256.C
    what, rays = batches[2]
    res["cluster_closest"]["err"] = max(
        res["cluster_closest"]["err"], check_closest(
            f"cluster_closest C=256 (K={grid256.num_clusters}) {what} "
            f"({rays.shape[1]} rays)",
            cuda_cluster.cluster_closest(rays, grid256),
            cuda_cluster.cluster_closest_plain(rays, grid256), rays,
            grid256.tri, BIG_T, False))
    rec["closest_checks"] = res
    return res


def phase_render_compare_cluster(rec):
    """accel="cluster" at 64x64, spp 1, on the card and on the CPU."""
    import numpy as np
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.models.collada import ColladaLoader
    scene = ColladaLoader.from_file(os.path.join(REPO, "data", "thai2.dae"),
                                    width=64, height=64, verbose=False)
    imgs = {}
    for dev in ("cuda", "cpu"):
        rt = rtx.RayTracer(scene, 64, 64, accel="cluster", device=dev,
                           draws=NumpyDraws(6, dev))
        t0 = time.perf_counter()
        imgs[dev] = rt.render(1)
        log(f"cluster render 64x64 spp 1 on {dev}: "
            f"{time.perf_counter() - t0:.2f} s")
    a, b = imgs["cuda"], imgs["cpu"]
    assert np.isfinite(a).all() and a.max() > 0
    flips = int((~np.isclose(a, b, rtol=2e-4, atol=2e-5)).sum())
    log(f"cluster render cuda vs cpu: {flips} of {a.size} values differ; "
        f"max |err| {float(np.abs(a - b).max())}")
    assert flips <= 3 * EDGE_RAYS, "cluster render disagrees with the CPU"
    rec["render_compare_cluster"] = dict(flips=flips, values=int(a.size))


def by_level(times, per_sample):
    """Per-launch (ms, rays) of a composable wavefront, grouped by
    level: each sample launches closest, shadow for levels 0, 1, 2."""
    out = {}
    for i, (ms, n) in enumerate(times):
        j = i % per_sample
        key = f"level {j // 2} {'shadow' if j % 2 else 'closest'}"
        out.setdefault(key, []).append(round(ms, 4))
    return out


def phase_cluster_main(rec):
    """accel="cluster": thai2 1024x1024, render(16) (or render(4) when the
    warm-up says render(16) would pass 60 s)."""
    import numpy as np
    import torch
    import raytracer_tpu_torch as rtx
    rt = rtx.create_raytracer_from_file(
        os.path.join(REPO, "data", "thai2.dae"), width=1024, height=1024,
        accel="cluster")
    g = rt.intersector.packed
    assert (g.num_clusters, g.C) == (157, 128), (g.num_clusters, g.C)
    t0 = time.perf_counter()
    rt.render(1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    spp = 16 if 16 * warm <= 60.0 else 4
    log(f"cluster warm-up render(1): {warm:.3f} s; timing render({spp})"
        + ("" if spp == 16 else " (render(16) would pass 60 s)"))
    rt.film.clear()
    torch.cuda.reset_peak_memory_stats()
    set_counts(timing=True)
    t0 = time.perf_counter()
    hdr = rt.render(spp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, times = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in cluster render({spp}): {counts}")
    assert counts == {"bvh_spawn": 0, "bvh_shadow_shade": 0,
                      "bvh_closest": 0, "cluster_closest": 6 * spp}, counts
    assert hdr.shape == (1024, 1024, 3) and np.isfinite(hdr).all()
    nonblack = float((hdr.sum(-1) > 0).mean())
    mrays = 1024 * 1024 * spp / secs / 1e6
    levels = by_level(times["cluster_closest"], 6)
    log(f"cluster render({spp}) thai2 1024x1024: {secs:.4f} s, {mrays:.4f} "
        f"primary Mrays/s, nonblack {nonblack:.4f}, peak {peak} B allocated")
    for key, lst in levels.items():
        log(f"  cluster_closest {key}: mean {sum(lst) / len(lst):.3f} ms "
            f"over {len(lst)} launches")
    assert nonblack > 0.05, "image is black"
    rec["cluster_main"] = dict(spp=spp, seconds=secs, mrays=mrays,
                               nonblack=nonblack, peak_bytes=peak,
                               launches=counts, per_level_ms=levels)
    return counts["cluster_closest"], times["cluster_closest"], rt


def phase_bvh_trace(rt, rec):
    """The composable wavefront over the BVH without records (what
    __graft_entry__.entry() runs) at full frame: 1 sample, 2 bounces."""
    import torch
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.core.engine import TorchStream
    from raytracer_tpu_torch.core.wavefront import trace_radiance
    isect = rtx.make_intersector("bvh", rt.scene_buffers)
    assert not isect.supports_fused_spawn
    o, d = frame_rays(rt, seed=8)
    trace_radiance(rt.scene_arrays, o, d, [TorchStream(9, "cuda")],
                   isect, 2, 1)                              # warm-up
    set_counts(timing=True)
    t0 = time.perf_counter()
    rad = trace_radiance(rt.scene_arrays, o, d, [TorchStream(10, "cuda")],
                         isect, 2, 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, times = read_counts()
    log(f"launches in the BVH trace_radiance frame: {counts}")
    assert counts == {"bvh_spawn": 0, "bvh_shadow_shade": 0,
                      "bvh_closest": 6, "cluster_closest": 0}, counts
    assert rad.shape == (o.shape[0], 3) and bool(rad.isfinite().all())
    nonblack = float((rad.sum(-1) > 0).float().mean())
    levels = by_level(times["bvh_closest"], 6)
    log(f"BVH trace_radiance 1024x1024 1 spp: {secs * 1e3:.3f} ms, "
        f"{o.shape[0] / secs / 1e6:.4f} primary Mrays/s, nonblack "
        f"{nonblack:.4f}; bvh_closest per level {levels}")
    assert nonblack > 0.05, "image is black"
    rec["bvh_trace"] = dict(seconds=secs, nonblack=nonblack, launches=counts,
                            per_level_ms=levels)
    return counts["bvh_closest"], times["bvh_closest"]


MAT_COLS = [0, 1, 2, 7]     # "mat" records: normal xyz, material id


def install_records(rt, fmt):
    """Install `fmt` ("full" or "mat") shading records built from rt's
    scene on its BVH, as a user would after construction."""
    from raytracer_tpu_torch.core.shade import build_slot_records
    isect = rt.intersector
    records = build_slot_records(rt.scene_arrays, isect.perm,
                                 isect.perm.shape[0])
    textured = bool((rt.scene_buffers.mat_tex_id >= 0).any())
    if fmt == "mat":
        isect.set_shade_records(records[:, MAT_COLS], fmt="mat",
                                textured=textured)
    else:
        isect.set_shade_records(records[:, :7 if textured else 6])
    return isect.shade_planes


def render_fresh(rt, spp, seed):
    """render(spp) into a cleared film with fresh draws from `seed`;
    returns (pixel sums on the card, seconds)."""
    import raytracer_tpu_torch as rtx
    import torch
    rt.film.clear()
    rt.draws = rtx.TorchDraws(seed, rt.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.render(spp)
    torch.cuda.synchronize()
    return rt.film.pixel_sum.clone(), time.perf_counter() - t0


def phase_mat(rt, rec):
    """The "mat" records: the spawn kernel with 4 record planes against
    its plain version at the full level-0 and level-1 shapes; render(16)
    of thai2 1024x1024 with "mat" against "full" records in turns; ico3_tex
    at 256x256 (textured) "mat" against "full"."""
    import torch
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.ops import cuda_bvh
    out = {}
    isect = rt.intersector
    bvh = isect.packed
    lp = rt.scene_arrays.light_pos
    kw = spawn_kw(isect)
    full = isect.shade_planes
    mat = install_records(rt, "mat")
    install_records(rt, "full")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    for level, b, rays, g, _, _ in wavefront_levels(rt, 8, gen):
        if level == 2:
            break
        R = rays.shape[1]
        got = cuda_bvh.bvh_spawn(rays, g, lp, bvh, mat, children=b, **kw)
        want, p_ms = timed(lambda: cuda_bvh.bvh_spawn_plain(
            rays, g, lp, bvh, mat, children=b, **kw))
        err = check_spawn(f"level {level} b={b} L=1, 4 'mat' record planes "
                          f"({R} rays)", got, want, rays, b, 1, bvh, mat)
        del got, want
        ms = {n: cuda_ms(lambda: cuda_bvh.bvh_spawn(rays, g, lp, bvh, planes,
                                                    children=b, **kw), 5)
              for n, planes in (("full", full), ("mat", mat))}
        log(f"spawn level {level} ({R} rays): {ms['mat']:.4f} ms with 4 "
            f"'mat' planes, {ms['full']:.4f} ms with 6 'full' planes; plain "
            f"{p_ms:.1f} ms")
        out[f"level{level}"] = dict(rays=R, err=err, ms_mat=ms["mat"],
                                    ms_full=ms["full"], plain_ms=p_ms)
    # render(16) in turns: full, mat, mat, full (same draws every time)
    films, secs = [], {"full": [], "mat": []}
    counts = None
    for fmt in ("full", "mat", "mat", "full"):
        install_records(rt, fmt)
        set_counts(timing=False)
        film, s = render_fresh(rt, 16, seed=31)
        c, _ = read_counts()
        if fmt == "mat":
            counts = c
        films.append(film)
        secs[fmt].append(s)
    install_records(rt, "full")
    differ = [int((f != films[0]).sum()) for f in films]
    log(f"render(16) thai2 1024x1024 in turns (full, mat, mat, full): "
        f"{secs['full'][0]:.4f} / {secs['mat'][0]:.4f} / {secs['mat'][1]:.4f}"
        f" / {secs['full'][1]:.4f} s; film values differing from the "
        f"first: {differ}; launches with 'mat' records: {counts}")
    assert counts == {"bvh_spawn": 6, "bvh_shadow_shade": 6,
                      "bvh_closest": 0, "cluster_closest": 0}, counts
    assert differ == [0, 0, 0, 0], "'mat' render differs from 'full'"
    assert float(films[0].sum()) > 0
    out["render16"] = dict(seconds=secs, differing=differ, launches=counts)
    # a textured scene: ico3_tex at 256x256, 2 spp
    rt_tex = rtx.create_raytracer_from_file(
        os.path.join(REPO, "data", "ico3_tex.dae"), width=256, height=256)
    films = {}
    for fmt in ("full", "mat"):
        install_records(rt_tex, fmt)
        assert rt_tex.intersector.fused_has_textures
        films[fmt], _ = render_fresh(rt_tex, 2, seed=32)
    n = int((films["mat"] != films["full"]).sum())
    log(f"render(2) ico3_tex 256x256 (textured): {n} of "
        f"{films['full'].numel()} film values differ between 'mat' and "
        "'full'")
    assert n == 0 and float(films["full"].sum()) > 0
    out["textured"] = dict(differing=n, values=films["full"].numel())
    rec["mat"] = out
    return out


def cli_run(argv, what):
    """raytracer_tpu_torch.cli.main(argv) in this process: its exit code,
    printed lines, launch counts, the wall time and the kernels' summed
    CUDA-event time (ms)."""
    import contextlib
    import io
    import torch
    from raytracer_tpu_torch import cli
    buf = io.StringIO()
    set_counts(timing=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, times = read_counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {what}: {line}")
    assert code == 0, f"{what} exited {code}"
    kernel_ms = sum(ms for lst in times.values() for ms, _ in lst)
    return lines, counts, secs, kernel_ms


def phase_cli(rec):
    """`python -m raytracer_tpu_torch.cli` at its defaults on thai2
    (1024x768, -m 70, 2 bounces) for one full progressive pass (16
    frames of 50 rows), then --accel cluster for 2 frames."""
    import numpy as np
    from raytracer_tpu_torch.utils.png_io import decode_png
    out_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "cli.png")
    if os.path.exists(png):
        os.remove(png)
    frames = 16
    lines, counts, secs, kernel_ms = cli_run(
        ["-f", os.path.join(REPO, "data", "thai2.dae"), "-i", str(frames),
         "--out", png], "cli")
    fps = [float(line.split()[1]) for line in lines
           if line.startswith("fps:")]
    rays = [int(line.split()[-1]) for line in lines
            if line.startswith("fps:")]
    assert len(fps) == frames, lines
    # each progressive frame is one fused wavefront: 3 levels
    want = {"bvh_spawn": 3 * frames, "bvh_shadow_shade": 3 * frames,
            "bvh_closest": 0, "cluster_closest": 0}
    assert counts == want, counts
    with open(png, "rb") as f:
        data = f.read()
    try:
        from PIL import Image
        img = np.asarray(Image.open(png))
    except ImportError:
        img = decode_png(data)
    assert img.shape == (768, 1024, 3) and img.max() > 0, img.shape
    frame_s = [1.0 / x for x in fps]
    mrays = sum(rays) / len(rays) / 1e6
    log(f"cli: {frames} frames, {secs:.3f} s in all (scene load and BVH "
        f"build included); per frame {min(frame_s) * 1e3:.3f}-"
        f"{max(frame_s) * 1e3:.3f} ms, mean {np.mean(frame_s) * 1e3:.3f} ms, "
        f"{mrays:.4f} primary Mrays/s (the CLI's own mean of frames); "
        f"kernels {kernel_ms / frames:.3f} ms a frame (CUDA events); "
        f"launches {counts}; PNG {len(data)} B")
    res = dict(seconds=secs, frame_ms=[s * 1e3 for s in frame_s],
               mrays_mean=mrays, kernel_ms_per_frame=kernel_ms / frames,
               launches=counts, png_bytes=len(data))
    lines, counts, secs, kernel_ms = cli_run(
        ["-f", os.path.join(REPO, "data", "thai2.dae"), "-i", "2",
         "--accel", "cluster", "--out", png], "cli --accel cluster")
    assert counts == {"bvh_spawn": 0, "bvh_shadow_shade": 0,
                      "bvh_closest": 0, "cluster_closest": 12}, counts
    log(f"cli --accel cluster -i 2: {secs:.3f} s, kernels "
        f"{kernel_ms / 2:.3f} ms a frame, launches {counts}")
    res["cluster"] = dict(seconds=secs, kernel_ms_per_frame=kernel_ms / 2,
                          launches=counts)
    rec["cli"] = res
    return res


INVERSE_FIELDS = ("mat_diffuse_rgb", "tri_verts")


def inverse_setup(dev, size, accel="brute"):
    """Inverse rendering of ico3_tex at size x size, 1 spp, 2 bounces,
    on `dev`: the target from the true scene by brute force, the start at
    albedo 0.5 with vertices perturbed by a seeded 1e-3, Adam over
    INVERSE_FIELDS, the steps over brute force or (accel="bvh") a BVH
    built from the start's vertices, so that the first step's forward is
    brute force's.  Returns step() -> (loss, {field: gradient}), one
    step with the target's draws."""
    import types
    import numpy as np
    import torch
    from raytracer_tpu_torch.core.intersectors import (BruteForceIntersector,
                                                       make_intersector)
    from raytracer_tpu_torch.diff.gradients import render_pixels
    from raytracer_tpu_torch.diff.inverse import (extract_params,
                                                  make_train_step,
                                                  merge_params)
    from raytracer_tpu_torch.models.collada import ColladaLoader
    scene = ColladaLoader.from_file(os.path.join(REPO, "data",
                                                 "ico3_tex.dae"),
                                    width=size, height=size, verbose=False)
    sa = scene.to_buffers().to_device(dev)
    cam = scene.cameras[0].params(dev)
    px = torch.arange(size, device=dev).repeat(size)
    py = torch.arange(size, device=dev).repeat_interleave(size)
    brute = BruteForceIntersector()
    with torch.no_grad():
        target = render_pixels(sa, cam, px, py, NumpyDraws(11, dev), size,
                               size, brute, recursions=2)
    noise = np.random.default_rng(12).standard_normal(
        tuple(sa.tri_verts.shape)).astype(np.float32)
    start = merge_params(sa, {
        "mat_diffuse_rgb": torch.full_like(sa.mat_diffuse_rgb, 0.5),
        "tri_verts": sa.tri_verts + 1e-3 * torch.from_numpy(noise).to(dev)})
    params = extract_params(start, INVERSE_FIELDS)
    opt = torch.optim.Adam([
        {"params": [params["mat_diffuse_rgb"]], "lr": 5e-2},
        {"params": [params["tri_verts"]], "lr": 1e-4}])
    isect = brute if accel == "brute" else make_intersector(
        accel, types.SimpleNamespace(
            tri_verts=start.tri_verts.detach().cpu().numpy()), device=dev)
    train = make_train_step(opt, cam, px, py, size, size, isect, target,
                            recursions=2)

    def step():
        _, loss = train(params, start, NumpyDraws(11, dev))
        return float(loss), {k: v.grad for k, v in params.items()}
    return step


def inverse_run(dev, size, steps, accel="brute"):
    """`steps` steps of `inverse_setup(dev, size, accel)`: the losses,
    seconds per step and the first step's gradients (numpy)."""
    import torch
    step = inverse_setup(dev, size, accel)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: 0)
    losses, secs, grads = [], [], None
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        loss, g = step()
        sync()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        if grads is None:
            grads = {k: v.detach().cpu().numpy() for k, v in g.items()}
    return losses, secs, grads


def phase_inverse(rec):
    """Inverse rendering (BASELINE config #5) on the card at 1024x1024,
    3 steps; the first step's gradients at 64x64 on the card against the
    CPU's; the autograd guard of the fused path."""
    import numpy as np
    import torch
    import raytracer_tpu_torch as rtx
    dev = torch.device("cuda")
    set_counts(timing=False)
    torch.cuda.reset_peak_memory_stats()
    losses, secs, _ = inverse_run(dev, 1024, 3)
    peak = torch.cuda.max_memory_allocated()
    counts, _ = read_counts()
    gathers = gather_counts()
    log(f"inverse rendering ico3_tex 1024x1024, 1 spp, 2 bounces, brute "
        f"force: losses {losses}, seconds per step {secs}, peak {peak} B "
        f"allocated; kernel launches {counts}; gather backward launches "
        f"in 3 steps {gathers}")
    assert all(np.isfinite(losses)) and losses[0] > 0
    assert losses[1] < losses[0] and losses[2] < losses[1], losses
    assert sum(counts.values()) == 0, counts
    # two tables (vertices, colours) at each of 3 levels a step
    assert gathers == 18, gathers
    out = dict(losses=losses, step_seconds=secs, peak_bytes=peak,
               gather_launches=gathers)
    (lk,), _, gk = inverse_run(dev, 64, 1)
    (lc,), _, gc = inverse_run(torch.device("cpu"), 64, 1)
    errs = {}
    for k in INVERSE_FIELDS:
        scale = float(np.abs(gc[k]).max())
        assert np.isfinite(gk[k]).all() and scale > 0, k
        rel = np.abs(gk[k] - gc[k]) / (1e-3 * np.abs(gc[k]) + 1e-5 * scale)
        errs[k] = float(rel.max())
    log(f"inverse step 64x64, card vs CPU: loss {lk} vs {lc}; gradient "
        f"error / tolerance (rtol 1e-3, atol 1e-5 of the largest) {errs}")
    assert abs(lk - lc) <= 1e-5 * abs(lc), (lk, lc)
    assert max(errs.values()) <= 1.0, errs
    out.update(loss64=(lk, lc), grad_err_over_tol=errs)
    rt = rtx.create_raytracer_from_file(
        os.path.join(REPO, "data", "ico3_tex.dae"), width=64, height=64)
    assert rt.fused
    rt.scene_arrays.mat_diffuse_rgb.requires_grad_(True)
    try:
        rt.render(1)
        raise AssertionError("the fused path ran under autograd")
    except ValueError as e:
        log(f"the fused path under autograd raises: {e}")
    finally:
        rt.scene_arrays.mat_diffuse_rgb.requires_grad_(False)
    rec["inverse"] = out
    return out


def phase_viewer(rec):
    """The viewer over create_inline_raytracer (1024x768, fused BVH) on a
    free local port: 3 frames, /frame.png, /stats, /key/w, shut down."""
    import json as json_
    import urllib.request
    from raytracer_tpu_torch.inline_scene import create_inline_raytracer
    from raytracer_tpu_torch.utils.png_io import decode_png
    from raytracer_tpu_torch.viewer import Viewer

    def get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{viewer.port}{path}", timeout=60) as r:
            return r.read()

    def wait(cond, what):
        end = time.monotonic() + 120
        while not cond():
            assert viewer.error is None, viewer.error
            assert time.monotonic() < end, f"viewer: no {what}"
            time.sleep(0.01)

    rt = create_inline_raytracer()
    set_counts(timing=False)
    t0 = time.perf_counter()
    viewer = Viewer(rt, port=0).start(serve=True)
    try:
        wait(lambda: viewer.state["frames"] >= 3, "3 frames")
        img = decode_png(get("/frame.png"))
        stats = json_.loads(get("/stats"))
        assert img.shape == (768, 1024, 3) and img.max() > 0, img.shape
        assert stats["frames"] >= 1, stats
        assert get("/key/w") == b"ok"
        wait(lambda: rt.camera.x_angle_radians != 0.0, "key")
    finally:
        viewer.close()
    secs = time.perf_counter() - t0
    counts, _ = read_counts()
    assert viewer.error is None, viewer.error
    frames = viewer.state["frames"]
    samples = float(rt.film.num_samples.sum())
    log(f"viewer on port {viewer.port}: {frames} frames in {secs:.3f} s, "
        f"stats {stats}, frame PNG {img.shape}, film samples after the "
        f"key {samples:.0f}; launches {counts}")
    assert samples <= (frames - 3) * rt.rows_per_frame * rt.width
    assert counts["bvh_spawn"] == counts["bvh_shadow_shade"] == 3 * frames
    rec["viewer"] = dict(frames=frames, seconds=secs, stats=stats,
                         launches=counts)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_train(mesh, dev, steps):
    """The sharded train step (brute force, 4boxes 64x64, 2 bounces):
    `steps` Adam steps over the albedo from grey toward the true scene's
    render, each with the same numpy-made draws; and one step of the
    unsharded diff.inverse.make_train_step from the same start and
    draws.  Returns ([sharded losses], first sharded (loss, grad,
    albedo), unsharded (loss, grad, albedo))."""
    import dataclasses
    import torch
    from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
    from raytracer_tpu_torch.diff.inverse import (extract_params,
                                                  make_train_step)
    from raytracer_tpu_torch.models.collada import ColladaLoader
    from raytracer_tpu_torch.parallel import (make_sharded_render,
                                              make_sharded_train_step,
                                              pixel_grid)
    n = 64
    scene = ColladaLoader.from_file(os.path.join(REPO, "data", "4boxes.dae"),
                                    width=n, height=n, verbose=False)
    sa = scene.to_buffers().to_device(dev)
    cam = scene.cameras[0].params(dev)
    px, py, _ = pixel_grid(n, n, pad_to=mesh.size)
    brute = BruteForceIntersector()
    with torch.no_grad():
        target = make_sharded_render(mesh, brute, n, n, recursions=2)(
            sa, cam, px, py, [NumpyDraws(20, dev)])
    start = dataclasses.replace(sa, mat_diffuse_rgb=torch.full_like(
        sa.mat_diffuse_rgb, 0.5))

    def fresh():
        params = extract_params(start, ("mat_diffuse_rgb",))
        return params, torch.optim.Adam(list(params.values()), lr=5e-2)

    def result(loss, params):
        p = params["mat_diffuse_rgb"]
        return (float(loss), p.grad.detach().cpu().numpy().copy(),
                p.detach().cpu().numpy().copy())

    params, opt = fresh()
    step = make_sharded_train_step(mesh, brute, n, n, opt, recursions=2)
    losses, first = [], None
    for _ in range(steps):
        loss, params = step(params, start, cam, px, py, target,
                            [NumpyDraws(21, dev)])
        losses.append(float(loss))
        first = first or result(loss, params)
    params, opt = fresh()
    one = make_train_step(opt, cam, torch.from_numpy(px).to(dev),
                          torch.from_numpy(py).to(dev), n, n, brute, target,
                          recursions=2)
    params, loss = one(params, start, NumpyDraws(21, dev))
    return losses, first, result(loss, params)


def phase_sharded(rt, rec, main_per_launch):
    """h. Multi-device rendering over NCCL at world size 1: the bring-up;
    render_sharded(16) of thai2 1024x1024 (fused BVH, pool 8) after a
    render_sharded(8) warm-up and a cleared film, its launch counts and
    per-level kernel times, and render(16) in turns (render, sharded,
    sharded, render); render_sharded of ico3_tex (textured, tpl 70) at
    64x64, spp 2, card against the CPU from the same numpy-made per-rank
    draws; the sharded train step against the unsharded one.  The
    process group is destroyed in any case."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.models.collada import ColladaLoader
    from raytracer_tpu_torch.parallel import (Mesh, initialize_distributed,
                                              make_mesh)
    out = {}
    t_phase = time.perf_counter()
    assert initialize_distributed(
        backend="nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0, timeout=120) is True
    try:
        assert initialize_distributed() is True
        mesh = make_mesh()
        assert mesh.size == 1 and mesh.group is not None, mesh
        log(f"process group: backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, mesh {mesh}")
        out["backend"] = dist.get_backend()

        t0 = time.perf_counter()
        rt.render_sharded(8)            # one wavefront at the timed pool
        torch.cuda.synchronize()
        log(f"warm-up render_sharded(8): {time.perf_counter() - t0:.3f} s")
        rt.film.clear()
        set_counts(timing=True)
        t0 = time.perf_counter()
        hdr = rt.render_sharded(16)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, times = read_counts()
        log(f"launches in render_sharded(16): {counts}")
        assert counts == {"bvh_spawn": 6, "bvh_shadow_shade": 6,
                          "bvh_closest": 0, "cluster_closest": 0}, counts
        assert hdr.shape == (1024, 1024, 3) and np.isfinite(hdr).all()
        nonblack = float((hdr.sum(-1) > 0).mean())
        assert nonblack > 0.05, "image is black"
        mrays = 1024 * 1024 * 16 / secs / 1e6
        log(f"render_sharded(16) thai2 1024x1024, world size 1 over NCCL: "
            f"{secs:.4f} s, {mrays:.4f} primary Mrays/s, nonblack "
            f"{nonblack:.4f}")
        levels = {}
        for name in ("bvh_spawn", "bvh_shadow_shade"):
            for i, (ms, n) in enumerate(times[name]):
                log(f"  {name} launch {i} (level {i % 3}, {n} rays): "
                    f"{ms:.3f} ms row-major; in tiles (phase 4a) "
                    f"{main_per_launch[name.split('_', 1)[1]][i][0]:.3f} ms")
            levels[name] = [ms for ms, _ in times[name]]
        out.update(seconds=secs, mrays=mrays, launches=counts,
                   per_launch_ms=levels)

        def timed_render(fn):
            rt.film.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(16)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        turns = [timed_render(f) for f in (rt.render, rt.render_sharded,
                                           rt.render_sharded, rt.render)]
        log(f"in turns, render / render_sharded / render_sharded / render "
            f"(16 spp): {turns} s")
        out["turns_s"] = turns

        scene = ColladaLoader.from_file(
            os.path.join(REPO, "data", "ico3_tex.dae"), width=64, height=64,
            verbose=False)
        films = {}
        for dev in ("cuda", "cpu"):
            r = rtx.RayTracer(scene, 64, 64, device=dev,
                              draws=NumpyDraws(5, dev))
            m = None if dev == "cuda" else Mesh(1, 0, torch.device("cpu"))
            films[dev] = r.render_sharded(2, mesh=m)
        a, b = films["cuda"], films["cpu"]
        assert np.isfinite(a).all() and a.max() > 0
        flips = int((~np.isclose(a, b, rtol=2e-4, atol=2e-5)).sum())
        log(f"render_sharded ico3_tex 64x64 spp 2, cuda vs cpu: {flips} of "
            f"{a.size} values differ; max |err| {float(np.abs(a - b).max())}")
        assert flips <= 3 * EDGE_RAYS, "render_sharded disagrees with the CPU"
        out["compare"] = dict(flips=flips, values=int(a.size))

        set_counts(timing=False)
        t0 = time.perf_counter()
        losses, first, one = sharded_train(mesh, torch.device("cuda"), 3)
        counts, _ = read_counts()
        log(f"sharded train step (4boxes 64x64, brute force, 2 bounces): "
            f"losses {losses}; unsharded first step loss {one[0]}; "
            f"{time.perf_counter() - t0:.2f} s; kernel launches {counts}")
        assert all(np.isfinite(losses)) and losses[0] > 0
        assert losses[1] < losses[0] and losses[2] < losses[1], losses
        assert sum(counts.values()) == 0, counts
        np.testing.assert_allclose(first[0], one[0], rtol=1e-5)
        for got, want in zip(first[1:], one[1:]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        out["train"] = dict(losses=losses, unsharded_loss=one[0])
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase h: {out['phase_s']:.1f} s")
    rec["sharded"] = out
    return out


def grad_err(got, want):
    """The largest |got - want| / (1e-3 |want| + 1e-5 max |want|) of one
    gradient leaf (the CPU tests' rule: at most 1 passes); 0 where both
    leaves are zero."""
    import numpy as np
    diff = np.abs(got - want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    if scale == 0.0:
        return 0.0 if not diff.any() else float("inf")
    return float((diff / (1e-3 * np.abs(want) + 1e-5 * scale)).max())


def leaf_grads(grads):
    """{leaf: numpy gradient} of every float leaf of scene_grads'
    (scene, camera) result."""
    import dataclasses
    return {f"{type(o).__name__}.{f.name}":
            getattr(o, f.name).detach().cpu().numpy()
            for o in grads for f in dataclasses.fields(o)
            if getattr(o, f.name) is not None}


def grad_scene(name, size, dev, accel):
    """(scene arrays, camera, px, py, intersector `accel` with tpl 70
    and no records) of data/<name> at size x size on `dev`."""
    import torch
    from raytracer_tpu_torch.core.intersectors import make_intersector
    from raytracer_tpu_torch.models.collada import ColladaLoader
    scene = ColladaLoader.from_file(os.path.join(REPO, "data", name),
                                    width=size, height=size, verbose=False)
    buf = scene.to_buffers()
    px = torch.arange(size, device=dev).repeat(size)
    py = torch.arange(size, device=dev).repeat_interleave(size)
    isect = make_intersector(accel, buf, device=dev)
    assert not getattr(isect, "supports_fused_spawn", False)
    return (buf.to_device(dev), scene.cameras[0].params(dev), px, py,
            isect)


def recompute_mismatch(isect, o, d):
    """(hit rays whose t, recomputed as winner_grad recomputes it, differs
    from the kernel's t; hit rays) of one query."""
    import torch
    from raytracer_tpu_torch.core.intersect import moller_trumbore
    with torch.no_grad():
        res = isect.query(None, o, d)
        hit = res["hit"]
        planes = isect.packed.tri[:, res["slot"][hit].long()]
        tw, _, _ = moller_trumbore(*o[hit].unbind(1), *d[hit].unbind(1),
                                   *planes.unbind(0))
        return int((tw != res["t"][hit]).sum()), int(hit.sum())


def primary_rays(sa, cam, px, py, size, seed):
    """The primary rays of one sample of NumpyDraws(seed)."""
    from raytracer_tpu_torch.models.camera import generate_rays
    jitter, _ = NumpyDraws(seed, px.device).next_sample(px.shape[0])
    return generate_rays(cam, px, py, jitter, size, size)


def phase_grads(rec, brute_losses):
    """i. Gradients over the kernel intersectors.
    (a) ico3_tex 64x64, 2 bounces: scene_grads over the BVH and the
        cluster grid on the card against the CPU's plain versions (the
        CPU tests' rule on every float leaf), the radiance under autograd
        equal bit for bit to the no_grad radiance, and the hit rays whose
        recomputed t differs from the kernel's;
    (b) fwd+bwd of thai2 1024x1024, 1 spp, 2 bounces over the BVH (tpl
        70, no records): seconds a step (median of 3 after a warm-up),
        primary Mrays/s, peak memory, bvh_closest launches (6 a step),
        the forward-only frame, and a profile of one step;
    (c) the inverse step of phase f over a BVH beside brute force's
        (`brute_losses`, phase f's);
    (d) the dry run at one rank over NCCL, training over the BVH."""
    import statistics
    import numpy as np
    import torch
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.diff.gradients import (_with_grad,
                                                    render_pixels,
                                                    scene_grads)
    out = {}
    t_phase = time.perf_counter()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    only = {"bvh_spawn": 0, "bvh_shadow_shade": 0, "bvh_closest": 0,
            "cluster_closest": 0}

    # (a) card against CPU at 64x64
    target = None
    for accel in ("bvh", "cluster"):
        kernel = "bvh_closest" if accel == "bvh" else "cluster_closest"
        grads = {}
        for side, dev in (("cpu", cpu), ("card", cuda)):
            sa, cam, px, py, isect = grad_scene("ico3_tex.dae", 64, dev,
                                                accel)
            with torch.no_grad():
                rad = render_pixels(sa, cam, px, py, NumpyDraws(31, dev),
                                    64, 64, isect, recursions=2)
            if target is None:
                target = rad * 0.8
            if side == "card":
                rad_g = render_pixels(_with_grad(sa), _with_grad(cam), px,
                                      py, NumpyDraws(31, dev), 64, 64, isect,
                                      recursions=2)
                bitwise = torch.equal(rad_g.detach().view(torch.int32),
                                      rad.view(torch.int32))
                differ, hits = recompute_mismatch(
                    isect, *primary_rays(sa, cam, px, py, 64, 31))
                set_counts(timing=False)
            grads[side] = leaf_grads(scene_grads(
                sa, cam, px, py, NumpyDraws(31, dev), 64, 64, isect,
                target.to(dev), recursions=2))
        counts, _ = read_counts()
        gathers = gather_counts()
        errs = {k: grad_err(grads["card"][k], grads["cpu"][k])
                for k in grads["cpu"]}
        log(f"i(a) gradients over {accel} (ico3_tex 64x64, 2 bounces), "
            f"card vs CPU: error / tolerance (rtol 1e-3, atol 1e-5 of the "
            f"largest) {errs}; radiance under autograd equal to no_grad bit "
            f"for bit: {bitwise}; primary hit rays whose recomputed t "
            f"differs from the kernel's: {differ} of {hits}; launches in "
            f"the card's step {counts}, gather backward {gathers}")
        assert bitwise, f"{accel}: the forward under autograd differs"
        assert max(errs.values()) <= 1.0, errs
        assert all(np.isfinite(g).all() for g in grads["card"].values())
        assert counts == {**only, kernel: 6}, counts
        # vertices, colours and the 640x640 atlas at each of 3 levels
        assert gathers == 9, gathers
        out[f"grad64_{accel}"] = dict(err_over_tol=errs, bitwise=bitwise,
                                      t_differ=differ, hits=hits,
                                      launches=counts,
                                      gather_launches=gathers)

    # (b) fwd+bwd of thai2 at 1024x1024 over the BVH
    n = 1024
    sa, cam, px, py, bvh = grad_scene("thai2.dae", n, cuda, "bvh")

    def forward():
        with torch.no_grad():
            return render_pixels(sa, cam, px, py, rtx.TorchDraws(41, cuda),
                                 n, n, bvh, recursions=2)
    forward()                                               # warm-up
    fwd = []
    for _ in range(3):
        rad, ms = timed(forward)
        fwd.append(ms / 1e3)
    assert bool(rad.isfinite().all()) and float(rad.max()) > 0
    target = rad * 0.8
    differ, hits = recompute_mismatch(bvh, *primary_rays(sa, cam, px, py, n,
                                                         41))

    def step():
        return scene_grads(sa, cam, px, py, rtx.TorchDraws(41, cuda), n, n,
                           bvh, target, recursions=2)
    step()                                                  # warm-up
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(3):
        set_counts(timing=False)
        (gs, gc), ms = timed(step)
        counts, _ = read_counts()
        gathers = gather_counts()
        assert counts == {**only, "bvh_closest": 6}, counts
        # 20,049 vertices, 2 colours and the 1-texel atlas; 3 levels
        assert gathers == 9, gathers
        secs.append(ms / 1e3)
    peak = torch.cuda.max_memory_allocated()
    grads = leaf_grads((gs, gc))
    assert all(np.isfinite(g).all() for g in grads.values())
    assert np.abs(grads["SceneArrays.mat_diffuse_rgb"]).max() > 0
    med = statistics.median(secs)
    log(f"i(b) fwd+bwd thai2 1024x1024, 1 spp, 2 bounces, BVH tpl 70: "
        f"seconds a step {secs} (median {med:.4f}), "
        f"{n * n / med / 1e6:.4f} fwd+bwd primary Mrays/s, peak {peak} B "
        f"allocated, bvh_closest launches a step {counts['bvh_closest']}, "
        f"gather backward {gathers}; "
        f"forward only (no_grad) {fwd} s; primary hit rays whose "
        f"recomputed t differs from the kernel's: {differ} of {hits}")
    out["fwd_bwd"] = dict(step_seconds=secs, median_s=med,
                          mrays=n * n / med / 1e6, peak_bytes=peak,
                          launches=counts, gather_launches=gathers,
                          forward_seconds=fwd, t_differ=differ, hits=hits)
    phase_profile("fwd+bwd step (thai2 1024x1024, BVH)", step, rec,
                  by_shape="_index_put_impl_")
    _, kept = gather_capture(step, 9)
    out["gather_fwd_bwd"] = check_gather("i(b) thai2 step", kept)
    del sa, cam, px, py, bvh, target, rad, gs, gc, grads, kept

    # (c) the inverse step over a BVH beside brute force's
    set_counts(timing=False)
    torch.cuda.reset_peak_memory_stats()
    (losses, isecs, _), kept = gather_capture(
        lambda: inverse_run(cuda, 1024, 3, accel="bvh"), 6)
    peak = torch.cuda.max_memory_allocated()
    counts, _ = read_counts()
    gathers = gather_counts()
    log(f"i(c) inverse rendering ico3_tex 1024x1024 over the BVH: losses "
        f"{losses} (brute force, phase f: {brute_losses}), seconds per "
        f"step {isecs}, peak {peak} B allocated; launches in 3 steps "
        f"{counts}, gather backward {gathers}")
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    assert abs(losses[0] - brute_losses[0]) <= 1e-4 * brute_losses[0], \
        (losses[0], brute_losses[0])
    assert counts == {**only, "bvh_closest": 18}, counts
    assert gathers == 18, gathers
    out["inverse_bvh"] = dict(losses=losses, brute_losses=brute_losses,
                              step_seconds=isecs, peak_bytes=peak,
                              launches=counts, gather_launches=gathers)
    out["gather_inverse"] = check_gather("i(c) inverse step (first)", kept)
    del kept

    # (d) the dry run, one rank over NCCL
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.parallel.dryrun",
         "--ranks", "1", "--timeout", "120"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180)
    lines = [ln for ln in run.stdout.splitlines() if "dryrun" in ln]
    log(f"i(d) dry run --ranks 1 over NCCL ({time.perf_counter() - t0:.1f} "
        f"s, exit {run.returncode}): " + " | ".join(lines))
    assert run.returncode == 0 and "dryrun: 1 of 1 ranks OK" in run.stdout, \
        run.stdout + run.stderr[-4000:]
    out["dryrun"] = lines
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase i: {out['phase_s']:.1f} s")
    rec["grads"] = out
    return out


def phase_profile(what, fn, rec, by_shape=None):
    """torch.profiler over one call of `fn` (a render, a progressive
    frame, a train step): device time by kernel and the device's busy
    share of the wall time; with `by_shape`, also the device time of
    each host op whose name holds that string, by its input shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_shape is not None) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    log(f"profile {what}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f} %)")
    for name, ms, n in kernels[:15]:
        log(f"  {ms:9.3f} ms  {n:4d}x  {name[:100]}")
    rec[f"profile_{what}"] = dict(wall_ms=wall_ms, busy_ms=busy,
                                  kernels=kernels[:40])
    if by_shape is not None:
        ops = [(e.key, str(e.input_shapes), e.device_time_total / 1e3,
                e.count)
               for e in prof.key_averages(group_by_input_shape=True)
               if by_shape in e.key and e.device_time_total > 0]
        ops.sort(key=lambda o: -o[2])
        for name, shapes, ms, n in ops[:12]:
            log(f"  {ms:9.3f} ms  {n:4d}x  {name} {shapes[:120]}")
        rec[f"profile_{what}"]["by_shape"] = ops[:40]


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and compare the kernels at a small size only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile by kernel a fused render(8), a "
                         "cluster render(2), a CLI frame and inverse "
                         "rendering steps over brute force and the BVH")
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
    from raytracer_tpu_torch.ops import cuda_build

    rec = {}
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    rec["card"] = card

    t0 = time.perf_counter()
    reports = cuda_build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"built kernels in {build_s:.2f} s")
    for name, report in reports.items():
        ptxas_lines(name, report)
    rec["build_s"] = build_s

    size = 256 if args.quick else 1024
    rt = rtx.create_raytracer_from_file(
        os.path.join(REPO, "data", "thai2.dae"), width=size, height=size,
        triangles_per_leaf=256)
    checks = phase_kernels(rt, args.quick, rec)
    closest = phase_closest_kernels(rt, args.quick, rec)
    if args.quick:
        return 0
    phase_render_compare(rec)
    phase_render_compare_cluster(rec)
    launches, per_launch = phase_main(rt, rec)
    n_cluster, cluster_times, rt_cluster = phase_cluster_main(rec)
    n_bvh, bvh_times = phase_bvh_trace(rt, rec)
    mat = phase_mat(rt, rec)
    phase_cli(rec)
    phase_inverse(rec)
    phase_viewer(rec)
    sharded = phase_sharded(rt, rec, per_launch)
    grads = phase_grads(rec, rec["inverse"]["losses"])
    if args.profile:
        phase_profile("fused render(8)", lambda: rt.render(8), rec)
        phase_profile("cluster render(2)", lambda: rt_cluster.render(2), rec)
        rt_cli = rtx.create_raytracer_from_file(
            os.path.join(REPO, "data", "thai2.dae"))     # the CLI's defaults
        rt_cli.trace_frame_additive()                     # warm-up
        phase_profile("CLI progressive frame (1024x768, tpl 70)",
                      rt_cli.trace_frame_additive, rec)
        step = inverse_setup(torch.device("cuda"), 1024)
        step()                                            # warm-up
        phase_profile("inverse step (ico3_tex 1024x1024, brute force)",
                      step, rec)
        step = inverse_setup(torch.device("cuda"), 1024, accel="bvh")
        step()                                            # warm-up
        phase_profile("inverse step (ico3_tex 1024x1024, BVH)", step, rec)

    common = dict(route="cuda", library_ms=None)
    kernels = []
    for name, replaces in (("spawn", "raytracer_tpu/ops/pallas_bvh.py:985"),
                           ("shadow_shade",
                            "raytracer_tpu/ops/pallas_bvh.py:1068")):
        c = checks[name]
        kernels.append({
            "name": f"bvh_{name}", **common,
            "source": "raytracer_tpu_torch/csrc/cuda_bvh.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "shape": f"main-path level 1, {c['rays']} rays",
            "levels_ms": [lv["ms"] for lv in c["levels"]],
            "levels_bound_ms": [lv["bound_ms"] for lv in c["levels"]],
            "levels_bound_rows_ms": [lv["bound_rows_ms"]
                                     for lv in c["levels"]],
            "tests_needed_per_ray": [lv["tests"] / lv["rays"]
                                     for lv in c["levels"]],
            "tests_needed_rows_per_ray": [lv["tests_rows"] / lv["rays"]
                                          for lv in c["levels"]],
            "tests_run_per_ray": [lv["tests_run"] / lv["rays"]
                                  for lv in c["levels"]],
            "main_path_ms": [round(ms, 4) for ms, _ in per_launch[name]],
            "launches_render_sharded": sharded["launches"][f"bvh_{name}"],
            "render_sharded_ms": [round(ms, 4) for ms in
                                  sharded["per_launch_ms"][f"bvh_{name}"]]})
        if name == "spawn":
            kernels[-1]["mat_records_ms"] = {
                f"level {i}": mat[f"level{i}"]["ms_mat"] for i in (0, 1)}
            kernels[-1]["max_abs_err"] = max(
                c["err"], *(mat[f"level{i}"]["err"] for i in (0, 1)))
    for name, source, replaces, n, times in (
            ("bvh_closest", "raytracer_tpu_torch/csrc/cuda_bvh.cu",
             "raytracer_tpu/ops/pallas_bvh.py:411", n_bvh, bvh_times),
            ("cluster_closest", "raytracer_tpu_torch/csrc/cuda_cluster.cu",
             "raytracer_tpu/ops/pallas_intersect.py:312", n_cluster,
             cluster_times)):
        c = closest[name]
        kernels.append({
            "name": name, **common, "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "shape": f"trace_radiance {c['batch']}, {c['rays']} rays",
            "levels_ms": {lv["batch"]: lv["ms"] for lv in c["levels"]},
            "levels_bound_ms": {lv["batch"]: lv["bound_ms"]
                                for lv in c["levels"]},
            "levels_bound_rows_ms": {lv["batch"]: lv["bound_rows_ms"]
                                     for lv in c["levels"]},
            "tests_needed_per_ray": {lv["batch"]: lv["tests"] / lv["rays"]
                                     for lv in c["levels"]},
            "tests_run_per_ray": {lv["batch"]: lv["tests_run"] / lv["rays"]
                                  for lv in c["levels"]},
            "tests_run_over_needed": {
                lv["batch"]: lv["tests_run"] / max(lv["tests"], 1)
                for lv in c["levels"]},
            "main_path_ms": by_level(times, 6)})
    kernels[2].update(
        launches_fwd_bwd_step=grads["fwd_bwd"]["launches"]["bvh_closest"],
        launches_inverse_bvh_3_steps=grads["inverse_bvh"]["launches"][
            "bvh_closest"],
        launches_grad64_step=grads["grad64_bvh"]["launches"]["bvh_closest"])
    kernels[3].update(launches_grad64_step=grads["grad64_cluster"][
        "launches"]["cluster_closest"])
    calls = grads["gather_inverse"] + grads["gather_fwd_bwd"]
    kernels.append({
        "name": "indexing_backward_rows", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/cuda_gather.cu",
        "replaces": None,
        "shape": "an ico3_tex 1024x1024 inverse step over the BVH (6 "
                 "calls), then a thai2 1024x1024 fwd+bwd step (9 calls)",
        "launches_inverse_step": rec["inverse"]["gather_launches"] / 3,
        "launches_fwd_bwd_step": grads["fwd_bwd"]["gather_launches"],
        "launches_grad64_step": grads["grad64_bvh"]["gather_launches"],
        "rows": [r["rows"] for r in calls],
        "tables": [r["table"] for r in calls],
        "ms": [r["ms"] for r in calls],
        "bound_ms": [r["bound_ms"] for r in calls], "bound_by": "bytes",
        "library_ms": {"index_put_": [r["index_put_ms"] for r in calls],
                       "index_add_": [r["index_add_ms"] for r in calls]},
        "max_abs_err": max(r["max_abs_err"] for r in calls),
        "err_over_depth_bound": max(r["err_over_bound"] for r in calls)})
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
