"""The port's fused-level intersector (ops/cuda_bvh.py) against the
Pallas kernels it replaces, pallas_bvh_spawn and pallas_bvh_shadow_shade
run in interpret mode, on identical inputs: the reference's BVH2 arrays,
its slot records, the same rays, draws and lights.  On the CPU the
port's wrappers run their plain PyTorch versions.

Tolerance: every output of a live ray agrees within float32 rounding
(rtol 1e-5) except on at most 24 of every 1536 live rays, the repo's
edge-flip rule (tests/test_fused_spawn.py:56-62); dead rays agree
exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.core.intersect import BIG_T
from raytracer_tpu.core.shade import build_slot_records as jax_slot_records
from raytracer_tpu.models.collada import ColladaLoader as JaxLoader
from raytracer_tpu.ops.pallas_bvh import (BVHIntersector as JaxBVH,
                                          pallas_bvh_shadow_shade,
                                          pallas_bvh_spawn)
from raytracer_tpu_torch.ops import cuda_bvh, cuda_cluster
from raytracer_tpu_torch.ops.cuda_bvh import BVHIntersector

N_RAYS = 1024          # one interpret-mode grid step of the TPU kernels
RB = 128


def _flip_budget(n):
    return 24 * n // 1536


def _setup(data_dir, scene="4boxes.dae"):
    sb = JaxLoader.from_file(data_dir / scene, verbose=False).to_buffers()
    ref = JaxBVH(sb, triangles_per_leaf=128, use_pallas=True)
    has_tex = bool((sb.mat_tex_id >= 0).any())
    records = np.array(jax_slot_records(sb.to_device(), ref.perm,
                                        ref.perm.shape[0]))
    records = records[:, :7 if has_tex else 6]
    ref.set_shade_records(jnp.asarray(records))
    b = ref.bvh
    port = BVHIntersector.from_bvh_arrays(
        b.perm, b.v0, b.e1, b.e2, b.leaf_aabb, b.seg_aabb, b.sc_aabb,
        b.orders, group=8, device="cpu")
    port.set_shade_records(torch.from_numpy(records))
    return sb, ref, port


def _rays(sb, seed, n=N_RAYS):
    """Half camera-like rays from outside toward the scene, half
    bounce-like rays starting inside its bounds in random directions."""
    rng = np.random.default_rng(seed)
    v = sb.tri_verts.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    c, span = 0.5 * (lo + hi), hi - lo
    h = n // 2
    o1 = c + span * (1.5 + rng.random((h, 3)))
    d1 = (c + 0.6 * span * (rng.random((h, 3)) - 0.5)) - o1
    o2 = lo + span * rng.random((n - h, 3))
    d2 = rng.normal(size=(n - h, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2]).astype(np.float32)
    return o, d


def _lights(sb, L):
    lp = sb.light_pos
    lc = sb.light_color
    if L == 2:
        lp = np.concatenate([lp, lp * np.array([[-1.0, 1.0, 1.0]])])
        lc = np.concatenate([lc, lc * 0.35])
    return lp.astype(np.float32), lc.astype(np.float32)


def _planes(x):
    """(n, R) numpy -> tuple of n (R // 128, 128) jax planes."""
    return tuple(jnp.asarray(r.reshape(-1, RB)) for r in x)


def _np(x):
    return np.asarray(x).reshape(-1)


def _run_both(ref, port, o, d, g, lp, b, key_mode):
    L = lp.shape[0]
    rays = np.concatenate([o.T, d.T]).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_bvh_spawn(
            _planes(rays[0:3]), _planes(rays[3:6]), _planes(g),
            jnp.asarray(lp), ref.v0, ref.e1, ref.e2, ref.seg_aabb,
            ref.sc_aabb, ref.orders, ref.shade_planes,
            world_lo=ref._world_lo_t, world_inv_span=ref._world_inv_t,
            group=8, n_lights=L, children=b,
            emit_uv=ref.fused_has_textures, key_mode=key_mode)
    got = port.spawn(torch.from_numpy(rays), torch.from_numpy(g),
                     torch.from_numpy(lp), children=b, key_mode=key_mode)
    return rays, want, got


def _close(a, b, atol=1e-6):
    """Per ray (column): every component within float32 rounding."""
    return np.isclose(a, b, rtol=1e-5, atol=atol).reshape(
        -1, a.shape[-1]).all(axis=0)


def _compare_spawn(rays, want, got, b, L, key_mode):
    """Counts the live rays that differ in ANY output (t, record, u/v,
    shadow rays, child rays, keys) and holds the count to the budget:
    the reference's XLA build contracts some a*b+c into FMAs, so t may
    move by an ulp and a ray on a triangle edge or a key-bin boundary
    may flip."""
    R = rays.shape[1]
    alive = np.abs(rays[0]) < 1e30
    # a hit point carries t's rounding times the ray's extent: positions
    # compare to 4 ulps of the largest live coordinate
    pos_tol = 4 * np.spacing(np.float32(max(1.0, np.abs(rays[:3, alive]).max())))
    t_w, t_g = _np(want["t"]), got["t"].numpy()
    bad = alive & ~_close(t_g[None], t_w[None])
    assert (t_g[~alive] == BIG_T).all()
    assert (t_g[alive & ~bad] < BIG_T).any(), "no hits: the case tests nothing"

    rec_w = np.stack([_np(r) for r in want["rec"]])
    bad |= alive & (got["rec"].numpy() != rec_w).any(axis=0)
    if "u" in want:
        for k in ("u", "v"):
            bad |= alive & ~_close(got[k].numpy()[None], _np(want[k])[None],
                                   atol=1e-4)

    sh_g = got["shadow"].numpy().reshape(6, L, R)
    for li in range(L):
        sh_w = np.stack([_np(p) for p in want["shadow"][li]])
        bad |= alive & ~_close(sh_g[:, li], sh_w, atol=pos_tol)

    if b:
        ch_g = got["children"].numpy().reshape(6, R, b)
        key_g = got["keys"].numpy().reshape(R, b)
        for j in range(b):
            ch_w = np.stack([_np(p) for p in want["children"][j][:6]])
            bad |= alive & ~_close(ch_g[:, :, j], ch_w, atol=pos_tol)
            bad |= alive & (key_g[:, j] != _np(want["children"][j][6]))
        live = key_g != 2 ** 30
        assert (key_g[live] < 2 ** 30).all() and (key_g[live] >= 0).all()
        hit = alive & (t_g < BIG_T)
        assert (live == hit[:, None]).all()
        assert (key_g[~alive] == 2 ** 30).all()
    assert bad.sum() <= _flip_budget(alive.sum()), \
        f"{bad.sum()} of {alive.sum()} live rays differ"


def _compare_shadow_shade(ref, port, want, rays, lp, lc):
    """Both shadow-shade versions on the reference spawn's outputs."""
    L = lp.shape[0]
    R = rays.shape[1]
    so = [np.concatenate([_np(want["shadow"][li][k]) for li in range(L)])
          for k in range(6)]
    n = [_np(want["rec"][k]) for k in range(3)]
    c = [_np(want["rec"][3 + k]) for k in range(3)]
    with pltpu.force_tpu_interpret_mode():
        rr = pallas_bvh_shadow_shade(
            _planes(so[0:3]), _planes(so[3:6]), _planes(n), _planes(c),
            _planes(rays[3:6]), jnp.asarray(lc), ref.v0, ref.e1, ref.e2,
            ref.seg_aabb, ref.sc_aabb, ref.orders, group=8, n_lights=L)
    rad_w = np.stack([_np(x) for x in rr])
    rad_g = port.shadow_shade(torch.from_numpy(np.stack(so)),
                              torch.from_numpy(np.stack(n)),
                              torch.from_numpy(np.stack(c)),
                              torch.from_numpy(rays[3:6].copy()),
                              torch.from_numpy(lc)).numpy()
    assert rad_g.shape == (3, L * R)
    close = np.isclose(rad_g, rad_w, rtol=1e-5, atol=1e-6).all(axis=0)
    assert (~close).sum() <= _flip_budget(L * R), \
        f"{(~close).sum()} of {L * R} shadow rays differ"
    assert rad_w.max() > 0.0


@pytest.fixture(scope="module")
def boxes(data_dir):
    return _setup(data_dir)


# every child count, light count and key mode, in four interpret-mode
# compilations (each distinct combination recompiles the TPU kernel)
@pytest.mark.parametrize("b,L,key_mode", [(0, 2, "dir6"), (1, 1, "dir9"),
                                          (2, 1, "dir6"), (2, 2, "dir9")])
def test_spawn_and_shadow_shade_match_pallas(boxes, b, L, key_mode):
    sb, ref, port = boxes
    o, d = _rays(sb, seed=10 * b + L)
    g = np.random.default_rng(99).normal(size=(3 * b, N_RAYS)).astype(np.float32)
    lp, lc = _lights(sb, L)
    rays, want, got = _run_both(ref, port, o, d, g, lp, b, key_mode)
    _compare_spawn(rays, want, got, b, L, key_mode)
    if b != 1:
        _compare_shadow_shade(ref, port, want, rays, lp, lc)


def test_spawn_textured_emits_uv(data_dir):
    sb, ref, port = _setup(data_dir, "ico3_tex.dae")
    assert ref.fused_has_textures and port.fused_has_textures
    o, d = _rays(sb, seed=5)
    g = np.random.default_rng(6).normal(size=(3, N_RAYS)).astype(np.float32)
    lp, lc = _lights(sb, 1)
    rays, want, got = _run_both(ref, port, o, d, g, lp, 1, "dir6")
    assert got["rec"].shape[0] == 7
    _compare_spawn(rays, want, got, 1, 1, "dir6")


def test_axis_parallel_and_dead_rays(boxes):
    """Zero direction components (the slab guard's sign-dropping 1e-30
    clamp), origins exactly on box planes, and dead rays: a wholly dead
    half plus scattered dead lanes."""
    sb, ref, port = boxes
    o, d = _rays(sb, seed=21)
    v = sb.tri_verts.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    rng = np.random.default_rng(22)
    n_ax = 256
    axis = rng.integers(0, 3, n_ax)
    d[:n_ax] = 0.0
    d[np.arange(n_ax), axis] = rng.choice([-1.0, 1.0], n_ax)
    o[:n_ax] = lo + (hi - lo) * rng.random((n_ax, 3))
    o[:n_ax:4, 0] = lo[0]              # origins on the x-min plane
    o[1:n_ax:4, 1] = hi[1]             # and on the y-max plane
    o[512:] = 1e35
    d[512:] = 1.0
    o[300:340] = 1e35
    d[300:340] = 1.0
    g = rng.normal(size=(3, N_RAYS)).astype(np.float32)
    lp, lc = _lights(sb, 1)
    rays, want, got = _run_both(ref, port, o, d, g, lp, 1, "dir6")
    _compare_spawn(rays, want, got, 1, 1, "dir6")
    t = got["t"].numpy()
    assert (t[512:] == BIG_T).all() and (t[300:340] == BIG_T).all()
    assert not np.isnan(t).any()
    assert (got["keys"].numpy()[512:] == 2 ** 30).all()
    _compare_shadow_shade(ref, port, want, rays, lp, lc)


def test_plain_closest_first_lane_wins_ties():
    """Two identical triangles in one row: the first lane keeps the tie
    (pallas_bvh.py:250-253), and a dead ray misses."""
    tri = np.zeros((9, 128), np.float32)
    for s in (3, 7):
        tri[0:3, s] = [0.0, 0.0, 1.0]        # v0
        tri[3:6, s] = [1.0, 0.0, 0.0]        # e1
        tri[6:9, s] = [0.0, 1.0, 0.0]        # e2
    rays = torch.tensor([[0.2, 1e35], [0.2, 1e35], [0.0, 1e35],
                         [0.0, 1.0], [0.0, 1.0], [1.0, 1.0]])
    t, slot, u, v = cuda_bvh.closest_plain(rays, torch.from_numpy(tri))
    assert t[0] == 1.0 and slot[0] == 3
    assert t[1] == BIG_T and slot[1] == -1 and u[1] == 0.0


def test_cpu_call_leaves_launch_counts_alone():
    """The launch counts are plain ints that only a kernel launch
    raises; a CPU call runs the plain version and leaves them alone."""
    before = (cuda_bvh.bvh_spawn.launches,
              cuda_bvh.bvh_shadow_shade.launches)
    bvh = cuda_bvh.PackedBVH(
        tri=torch.zeros((9, 128)), seg_aabb=torch.zeros((32, 8)),
        sc_aabb=torch.zeros((1, 8)), orders=torch.zeros((6, 1), dtype=torch.int32),
        C=128, S=4, G=8)
    rays = torch.ones((6, 4))
    cuda_bvh.bvh_spawn(rays, torch.zeros((0, 4)), torch.zeros((1, 3)), bvh,
                       torch.zeros((6, 128)), world_lo=(0, 0, 0),
                       world_inv_span=(1, 1, 1), children=0, emit_uv=False)
    assert (cuda_bvh.bvh_spawn.launches,
            cuda_bvh.bvh_shadow_shade.launches) == before
    assert isinstance(before[0], int) and isinstance(before[1], int)


# --- the generic closest hit (bvh_closest <- pallas_bvh_closest) ----------

from raytracer_tpu.core.intersect import closest_hit as jax_closest  # noqa: E402
from raytracer_tpu.ops.bvh import build_bvh2 as jax_build_bvh2  # noqa: E402
from raytracer_tpu.ops.pallas_bvh import pallas_bvh_closest  # noqa: E402
from raytracer_tpu.ops.pallas_intersect import (  # noqa: E402
    DEAD_ORIGIN, xla_cluster_closest)
from tests.test_torch_intersect import (T_ATOL, _t,  # noqa: E402
                                        assert_hits_match, random_rays,
                                        random_scene)


def _closest_setup(n_tris=3000, seed=5):
    tris = random_scene(n_tris, seed=seed)
    b = jax_build_bvh2(tris, triangles_per_leaf=128, group=8)
    port = BVHIntersector.from_bvh_arrays(
        b.perm, b.v0, b.e1, b.e2, b.leaf_aabb, b.seg_aabb, b.sc_aabb,
        b.orders, group=8, device="cpu")
    args = tuple(jnp.asarray(a) for a in (b.v0, b.e1, b.e2, b.seg_aabb,
                                          b.sc_aabb, b.orders))
    return tris, b, port, args


def _pallas_closest(o, d, args, **kw):
    out = pallas_bvh_closest(jnp.asarray(o), jnp.asarray(d), *args,
                             interpret=True, **kw)
    return np.asarray(out) if kw.get("shadow") else [np.asarray(x)
                                                     for x in out]


@pytest.fixture(scope="module")
def closest_case():
    return _closest_setup()


def test_bvh_closest_plain_matches_pallas_and_xla(closest_case):
    """Closest mode with 6 record planes: t/u/v/slot against the Pallas
    kernel in interpret mode, the records against records[slot], and
    the triangle against the XLA fallback and brute force."""
    tris, b, port, args = closest_case
    o, d = random_rays(1024, seed=6)
    S = b.num_leaves * b.leaf_size
    records = np.random.default_rng(23).random((S, 6)).astype(np.float32)
    planes = tuple(jnp.asarray(records[:, k].reshape(b.num_leaves,
                                                     b.leaf_size))
                   for k in range(6))
    tp, up, vp, ip, *recs = _pallas_closest(o, d, args, rec_planes=planes)
    got = cuda_bvh.bvh_closest(cuda_bvh.rays_from(_t(o), _t(d)), port.packed,
                               _t(records.T.copy()))
    got = {k: v.numpy() for k, v in got.items()}
    hit = tp < BIG_T
    assert_hits_match(got["t"], b.perm[np.maximum(got["slot"], 0)], tp, hit,
                      b.perm[ip], o, d, tris)
    same = hit & (got["slot"] == ip)
    np.testing.assert_allclose(got["u"][same], up[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["v"][same], vp[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["rec"][:, same],
                                  np.stack(recs)[:, same])
    np.testing.assert_array_equal(got["rec"][:, hit],
                                  records[got["slot"][hit]].T)
    assert (got["rec"][:, ~hit] == 0).all() and (got["slot"][~hit] == -1).all()
    tx, _, _, ix = (np.asarray(x) for x in xla_cluster_closest(
        jnp.asarray(o), jnp.asarray(d), *args[:3],
        jnp.asarray(b.leaf_aabb[:, 0:3]), jnp.asarray(b.leaf_aabb[:, 3:6])))
    assert_hits_match(got["t"], b.perm[np.maximum(got["slot"], 0)], tx,
                      tx < BIG_T, b.perm[ix], o, d, tris)


def test_bvh_closest_t_limit_and_shadow_mode(closest_case):
    """Below a t limit the hit is exact; shadow mode returns t only, and
    the intersector's shadow is the (0.01, 1.0) window of the closest
    hit, as the Pallas kernel's shadow mode gives it."""
    tris, b, port, args = closest_case
    o, d = random_rays(1024, seed=10)
    brute = jax_closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris))
    bt = np.asarray(brute["t"])
    limit = float(np.median(bt[bt < BIG_T]))
    rays = cuda_bvh.rays_from(_t(o), _t(d))
    got = cuda_bvh.bvh_closest(rays, port.packed, t_limit=limit)["t"].numpy()
    tl = _pallas_closest(o, d, args, t_limit=limit)[0]
    below = bt <= limit * 0.999
    np.testing.assert_allclose(got[below], tl[below], rtol=1e-5, atol=T_ATOL)
    assert below.any()

    sh = cuda_bvh.bvh_closest(rays, port.packed, t_limit=1.0, shadow=True)
    assert set(sh) == {"t"}
    ts = _pallas_closest(o, d, args, t_limit=1.0, shadow=True)
    window = (ts < BIG_T) & (ts > 0.01) & (ts < 1.0)
    np.testing.assert_array_equal(port.shadow(None, _t(o), _t(d)).numpy(),
                                  window)
    assert window.any()


def test_bvh_query_dead_rays_and_variants(closest_case):
    """The intersector's query: alive=False and sentinel-origin rays
    miss with slot 0 and tri 0; live rays match brute force through the
    slot permutation; exact_order and stream give identical results."""
    tris, b, port, args = closest_case
    o, d = random_rays(1024, seed=14)
    alive = np.ones(1024, bool)
    alive[100:200] = False
    o[700:] = DEAD_ORIGIN
    d[700:] = 1.0
    q = port.query(None, _t(o), _t(d), alive=_t(alive))
    live = alive.copy()
    live[700:] = False
    assert not q["hit"].numpy()[~live].any()
    assert (q["slot"].numpy()[~live] == 0).all()
    assert (q["tri"].numpy()[~live] == 0).all()
    brute = jax_closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris))
    assert_hits_match(q["t"].numpy(), q["tri"].numpy(), brute["t"],
                      brute["hit"], brute["tri"], o, d, tris, mask=live)
    rays = cuda_bvh.rays_from(_t(o), _t(d))
    base = cuda_bvh.bvh_closest(rays, port.packed)
    for kw in (dict(exact_order=True), dict(exact_order=False),
               dict(stream=True)):
        res = cuda_bvh.bvh_closest(rays, port.packed, **kw)
        for k in base:
            np.testing.assert_array_equal(res[k].numpy(), base[k].numpy())


def test_bvh_closest_axis_parallel_rays():
    """Zero direction components with origins exactly on box planes: the
    BVH walk's guarded inverse keeps every slab product finite, so the
    Pallas kernel finds what the dense plain version finds."""
    tris = np.array([
        [[0, 0, 1], [1, 0, 1], [0, 1, 1]],
        [[1, 0, 1], [1, 1, 1], [0, 1, 1]],
    ], np.float32)
    b = jax_build_bvh2(tris, triangles_per_leaf=128, group=8)
    port = BVHIntersector.from_bvh_arrays(
        b.perm, b.v0, b.e1, b.e2, b.leaf_aabb, b.seg_aabb, b.sc_aabb,
        b.orders, group=8, device="cpu")
    args = tuple(jnp.asarray(a) for a in (b.v0, b.e1, b.e2, b.seg_aabb,
                                          b.sc_aabb, b.orders))
    o = np.array([[0.25, 0.25, 0.0], [0.0, 0.25, 0.0], [0.0, 0.0, 0.0],
                  [1.0, 1.0, 0.0], [2.0, 0.25, 0.0], [0.25, 0.25, 1.0]],
                 np.float32)
    d = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1],
                  [1, 0, 0]], np.float32)
    n = len(o)
    o = np.concatenate([o, np.full((1024 - n, 3), DEAD_ORIGIN, np.float32)])
    d = np.concatenate([d, np.ones((1024 - n, 3), np.float32)])
    want = _pallas_closest(o, d, args)[0]
    got = port.query(None, _t(o), _t(d))["t"].numpy()
    np.testing.assert_array_equal(got < BIG_T, want < BIG_T)
    np.testing.assert_allclose(got[:4], 1.0, rtol=1e-6)
    assert got[4] == BIG_T and not np.isnan(got).any()


# --- the wrappers' operand checks (any device) -----------------------------


def _packed(C=128, G=8, S=4, K1=1):
    NL = K1 * G
    return cuda_bvh.PackedBVH(
        tri=torch.zeros((9, NL * C)), seg_aabb=torch.zeros((NL * S, 8)),
        sc_aabb=torch.zeros((K1, 8)),
        orders=torch.zeros((6, K1), dtype=torch.int32), C=C, S=S, G=G)


def _spawn_operands(R=4, b=1, L=1, n_rec=6):
    bvh = _packed()
    return dict(rays=torch.zeros((6, R)), gauss=torch.zeros((3 * b, R)),
                light_pos=torch.zeros((L, 3)), bvh=bvh,
                rec=torch.zeros((n_rec, bvh.num_slots)), children=b)


def _shade_operands(R=4, L=2):
    return dict(shadow_rays=torch.zeros((6, L * R)),
                normal=torch.zeros((3, R)), color=torch.zeros((3, R)),
                view=torch.zeros((3, R)), light_color=torch.zeros((L, 3)),
                bvh=_packed())


def _spawn(**kw):
    ops = _spawn_operands()
    ops.update(kw)
    return cuda_bvh.bvh_spawn(world_lo=(0.0,) * 3, world_inv_span=(1.0,) * 3,
                              emit_uv=False, **ops)


def _shade(**kw):
    ops = _shade_operands()
    ops.update(kw)
    return cuda_bvh.bvh_shadow_shade(**ops)


def _closest(**kw):
    bvh = _packed()
    ops = dict(rays=torch.zeros((6, 4)), bvh=bvh)
    ops.update(kw)
    if ops.get("rec") == "wide":
        ops["rec"] = torch.zeros((9, bvh.num_slots))
    elif ops.get("rec") == "short":
        ops["rec"] = torch.zeros((6, bvh.num_slots - 1))
    return cuda_bvh.bvh_closest(**ops)


def _grid(C=128, K=2):
    return cuda_cluster.PackedGrid(
        tri=torch.zeros((9, K * C)), aabb=torch.zeros((K, 8)),
        orders=torch.zeros((6, K), dtype=torch.int32), C=C)


def _cluster_closest(**kw):
    ops = dict(rays=torch.zeros((6, 4)), grid=_grid())
    ops.update(kw)
    return cuda_cluster.cluster_closest(**ops)


@pytest.mark.parametrize("call,kw,what", [
    (_spawn, dict(rays=torch.zeros((5, 4))), "rays"),
    (_spawn, dict(gauss=torch.zeros((3, 5))), "gauss"),
    (_spawn, dict(gauss=torch.zeros((6, 4))), "gauss"),
    (_spawn, dict(light_pos=torch.zeros((1, 4))), "light_pos"),
    (_spawn, dict(rec=torch.zeros((2, 1024))), "rec"),
    (_spawn, dict(rec=torch.zeros((9, 1024))), "rec"),
    (_spawn, dict(rec=torch.zeros((6, 1023))), "rec"),
    (_spawn, dict(key_mode="dir7"), "key_mode"),
    (_shade, dict(shadow_rays=torch.zeros((6, 7))), "shadow rays"),
    (_shade, dict(shadow_rays=torch.zeros((5, 8))), "shadow rays"),
    (_shade, dict(color=torch.zeros((3, 5))), "color"),
    (_shade, dict(view=torch.zeros((4, 4))), "view"),
    (_closest, dict(rays=torch.zeros((3, 4))), "rays"),
    (_closest, dict(rec="wide"), "rec"),
    (_closest, dict(rec="short"), "rec"),
    (_cluster_closest, dict(rays=torch.zeros((3, 4))), "rays"),
    (_cluster_closest, dict(rays=torch.zeros((7, 4))), "rays"),
])
def test_wrappers_raise_on_mismatched_operands(call, kw, what):
    """Each wrapper checks its operands' shapes before it picks a device,
    so a CPU call raises where a kernel launch would."""
    with pytest.raises(ValueError, match=what):
        call(**kw)


@pytest.mark.parametrize("call", [_spawn, _shade, _closest,
                                  _cluster_closest])
def test_wrappers_take_matching_operands_on_the_cpu(call):
    """The same operands with matching shapes run the plain versions:
    every ray here is a miss (zero-area triangles)."""
    out = call()
    t = out["t"] if isinstance(out, dict) else None
    if t is not None:
        assert bool((t == BIG_T).all())
    else:
        assert out.shape == (3, 8) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("count", [
    lambda: cuda_bvh.bvh_tests_needed(torch.zeros((6, 4)), _packed()),
    lambda: cuda_cluster.cluster_tests_needed(torch.zeros((6, 4)), _grid()),
], ids=["bvh", "cluster"])
def test_counting_entries_raise_on_the_cpu(count):
    """The per-ray counting walks (the bounds' yardstick) run on the card
    only: a CPU tensor raises, with no plain fallback."""
    with pytest.raises(ValueError, match="CUDA device"):
        count()
