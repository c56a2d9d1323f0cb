"""The port's intersection layer against the JAX package on identical
numpy-made inputs: the cluster-grid builder (ops/cluster.py, arrays
equal), the brute-force oracle (core/intersect.py) on the cases of
tests/test_intersect.py, and the cluster kernel's plain version
(ops/cuda_cluster.py) against pallas_cluster_closest in interpret mode
and its XLA fallback.

Tolerance of the hit comparisons (tests/test_pallas_bvh.py
assert_matches_brute): the hit mask equal, t within rtol 1e-5, and the
triangle equal except on an exact-t tie, where the two walks may keep
different triangles that the port's own Moller-Trumbore hits at the
same t.  t also passes within 1e-7 absolute: the reference's XLA build
may contract a*b+c, which moves t by an ulp of the origin-scale terms
(|o| ~ 8 here), more than 1e-5 of a t near 0.1."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import native as jax_native
from raytracer_tpu.core.intersect import any_hit_window as jax_any_hit
from raytracer_tpu.core.intersect import closest_hit as jax_closest
from raytracer_tpu.models.collada import ColladaLoader as JaxLoader
from raytracer_tpu.ops.cluster import build_cluster_grid as jax_grid
from raytracer_tpu.ops.cluster import morton_codes as jax_morton_codes
from raytracer_tpu.ops.pallas_intersect import (DEAD_ORIGIN,
                                                pallas_cluster_closest,
                                                xla_cluster_closest)
from raytracer_tpu_torch import native
from raytracer_tpu_torch.core.intersect import (BIG_T, any_hit_window,
                                                closest_hit, moller_trumbore)
from raytracer_tpu_torch.core.intersectors import (BruteForceIntersector,
                                                   make_intersector)
from raytracer_tpu_torch.ops import cuda_cluster
from raytracer_tpu_torch.ops.cluster import build_cluster_grid, morton_codes
from raytracer_tpu_torch.ops.cuda_bvh import rays_from
from raytracer_tpu_torch.ops.cuda_cluster import ClusterIntersector


def random_scene(n=300, seed=1):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, size=(n, 1, 3))
    tris = base + rng.uniform(-0.8, 0.8, size=(n, 3, 3))
    return tris.astype(np.float32)


def random_rays(r=64, seed=2):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    return o, d


T_ATOL = 1e-7


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tie_ok(o, d, tris, a, b):
    """True where the port's Moller-Trumbore hits triangles a and b of
    ray i at the same t (an exact tie)."""
    def t_of(idx):
        tv = _t(tris[idx])
        v0 = tv[:, 0]
        e1, e2 = tv[:, 1] - v0, tv[:, 2] - v0
        ray = [c for c in torch.cat([_t(o), _t(d)], 1).unbind(1)]
        return moller_trumbore(*ray, *(x[:, k] for x in (v0, e1, e2)
                                       for k in range(3)))[0].numpy()
    return t_of(a) == t_of(b)


def assert_hits_match(got_t, got_tri, want_t, want_hit, want_tri, o, d,
                      tris, mask=None):
    got_t = np.asarray(got_t)
    if mask is None:
        mask = np.ones(len(got_t), bool)
    hit = got_t < BIG_T
    np.testing.assert_array_equal(hit[mask], np.asarray(want_hit)[mask])
    sel = mask & hit
    np.testing.assert_allclose(got_t[sel], np.asarray(want_t)[sel],
                               rtol=1e-5, atol=T_ATOL)
    got_tri, want_tri = np.asarray(got_tri), np.asarray(want_tri)
    other = np.nonzero(sel & (got_tri != want_tri))[0]
    if other.size:
        assert _tie_ok(o[other], d[other], tris, got_tri[other],
                       want_tri[other]).all(), "triangle differs off a tie"
    assert sel.sum() > 0, "no hits: the case tests nothing"


# --- the cluster-grid builder ------------------------------------------------


@pytest.fixture(scope="module")
def thai2_tris(data_dir):
    return JaxLoader.from_file(data_dir / "thai2.dae",
                               verbose=False).to_buffers().tri_verts


@pytest.mark.parametrize("tpl,K,C", [(70, 157, 128), (256, 79, 256)])
def test_build_cluster_grid_equals_reference(thai2_tris, tpl, K, C):
    got = build_cluster_grid(thai2_tris, triangles_per_leaf=tpl)
    want = jax_grid(thai2_tris, triangles_per_leaf=tpl)
    assert (got.num_clusters, got.cluster_size) == (K, C)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_morton_order_equals_reference(thai2_tris):
    """The native Morton sort and the numpy fallback's codes."""
    np.testing.assert_array_equal(native.morton_order(thai2_tris),
                                  jax_native.morton_order(thai2_tris))
    pts = thai2_tris.mean(axis=1)
    lo, hi = pts.min(0), pts.max(0)
    np.testing.assert_array_equal(morton_codes(pts, lo, hi),
                                  jax_morton_codes(pts, lo, hi))


def test_cluster_grid_empty_scene():
    got = build_cluster_grid(np.zeros((0, 3, 3), np.float32))
    want = jax_grid(np.zeros((0, 3, 3), np.float32))
    assert got.num_clusters == want.num_clusters == 1
    np.testing.assert_array_equal(got.perm, want.perm)


# --- the brute-force oracle (tests/test_intersect.py's cases) ---------------


def single_tri():
    return np.array([[[0, 0, 5], [2, 0, 5], [0, 2, 5]]], np.float32)


TWO_TRIS = np.array([[[0, 0, 5], [2, 0, 5], [0, 2, 5]],
                     [[0, 0, 3], [2, 0, 3], [0, 2, 3]]], np.float32)


@pytest.mark.parametrize("case,o,d,tris", [
    ("hit", [0.5, 0.5, 0.0], [0.0, 0.0, 1.0], single_tri()),
    ("behind", [0.5, 0.5, 10.0], [0.0, 0.0, 1.0], single_tri()),
    ("parallel", [0.5, 0.5, 0.0], [1.0, 0.0, 0.0], single_tri()),
    ("closest_of_two", [0.5, 0.5, 0.0], [0.0, 0.0, 1.0], TWO_TRIS),
])
def test_closest_hit_cases_match_reference(case, o, d, tris):
    o = np.array([o], np.float32)
    d = np.array([d], np.float32)
    got = closest_hit(_t(o), _t(d), _t(tris))
    want = jax_closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris))
    for k in ("t", "u", "v", "tri", "hit"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    expect = {"hit": (True, 5.0, 0), "behind": (False, BIG_T, 0),
              "parallel": (False, BIG_T, 0),
              "closest_of_two": (True, 3.0, 1)}[case]
    assert (bool(got["hit"][0]), float(got["t"][0]),
            int(got["tri"][0])) == pytest.approx(expect)


def test_any_hit_window_semantics_match_reference():
    """A closest hit below the window unblocks even with an occluder
    inside it (mod.rs:224-230)."""
    tris = np.array([
        [[-9, -9, 0.005], [9, -9, 0.005], [0, 9, 0.005]],
        [[-9, -9, 0.5], [9, -9, 0.5], [0, 9, 0.5]],
    ], np.float32)
    o = np.array([[0.0, 0.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    for sub in (tris, tris[1:]):
        got = any_hit_window(_t(o), _t(d), _t(sub))
        want = jax_any_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(sub))
        assert bool(got[0]) == bool(want[0])
    assert not bool(any_hit_window(_t(o), _t(d), _t(tris))[0])


@pytest.mark.parametrize("chunk", [64, 512])
def test_closest_hit_matches_reference_random(chunk):
    tris = random_scene(700, seed=7)
    o, d = random_rays(256, seed=8)
    got = closest_hit(_t(o), _t(d), _t(tris), chunk=chunk)
    want = jax_closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris))
    assert_hits_match(got["t"], got["tri"], want["t"], want["hit"],
                      want["tri"], o, d, tris)
    sel = got["hit"].numpy()
    np.testing.assert_allclose(got["u"].numpy()[sel],
                               np.asarray(want["u"])[sel], rtol=1e-4,
                               atol=1e-5)
    # the brute intersector's query/shadow are these two functions
    scene = type("S", (), {"tri_verts": _t(tris)})
    brute = make_intersector("brute")
    assert isinstance(brute, BruteForceIntersector)
    q = brute.query(scene, _t(o), _t(d))
    np.testing.assert_array_equal(q["t"].numpy(), got["t"].numpy())
    blocked = brute.shadow(scene, _t(o), _t(d))
    np.testing.assert_array_equal(
        blocked.numpy(), np.asarray(jax_any_hit(jnp.asarray(o),
                                                jnp.asarray(d),
                                                jnp.asarray(tris))))


def test_sign_test_acceptance_equals_the_chain():
    """min(u, v, 1-(u+v), t) >= 0 accepts exactly the pairs that the
    chain u>=0 & u<=1 & v>=0 & u+v<=1 & t>=0 accepts
    (pallas_intersect.py:270-271), NaN included, so one plain MT
    function serves the BVH and the cluster kernels."""
    rng = np.random.default_rng(0)
    edge = np.array([0.0, -0.0, 1.0, 0.5, 1e-8, -1e-8, 1 - 2 ** -24,
                     1 + 2 ** -23, np.nan, np.inf, -np.inf, 2.0],
                    np.float32)
    u = np.concatenate([rng.uniform(-0.2, 1.2, 200000).astype(np.float32),
                        np.repeat(edge, len(edge) * 3)])
    v = np.concatenate([rng.uniform(-0.2, 1.2, 200000).astype(np.float32),
                        np.tile(np.repeat(edge, 3), len(edge))])
    t = np.concatenate([rng.uniform(-1, 1, 200000).astype(np.float32),
                        np.tile(np.array([1.0, -1.0, np.nan], np.float32),
                                len(edge) ** 2)])
    uu, vv, tt = _t(u), _t(v), _t(t)
    sign = (torch.minimum(torch.minimum(uu, vv),
                          torch.minimum(1.0 - (uu + vv), tt)) >= 0.0)
    chain = ((uu >= 0) & (uu <= 1) & (vv >= 0) & (uu + vv <= 1) & (tt >= 0))
    np.testing.assert_array_equal(sign.numpy(), chain.numpy())


# --- the cluster kernel's plain version vs the Pallas kernel ----------------


def _cluster(tris, tpl=70):
    grid = jax_grid(tris, triangles_per_leaf=tpl)
    port = ClusterIntersector.from_grid_arrays(
        grid.perm, grid.v0, grid.e1, grid.e2, grid.aabb_min, grid.aabb_max,
        grid.orders, device="cpu")
    aabb8 = np.zeros((grid.num_clusters, 8), np.float32)
    aabb8[:, :3], aabb8[:, 3:6] = grid.aabb_min, grid.aabb_max
    args = tuple(jnp.asarray(a) for a in (grid.v0, grid.e1, grid.e2, aabb8,
                                          grid.orders))
    return grid, port, args


def _pallas(o, d, args, **kw):
    return [np.asarray(x) for x in pallas_cluster_closest(
        jnp.asarray(o), jnp.asarray(d), *args, interpret=True, **kw)]


def _plain(port, o, d):
    res = cuda_cluster.cluster_closest(rays_from(_t(o), _t(d)), port.packed)
    return {k: v.numpy() for k, v in res.items()}


def test_cluster_plain_matches_pallas_and_xla():
    tris = random_scene(700, seed=11)
    o, d = random_rays(1024, seed=12)
    grid, port, args = _cluster(tris)
    assert grid.num_clusters > 1
    got = _plain(port, o, d)
    perm = np.maximum(grid.perm, 0)
    tp, up, vp, ip = _pallas(o, d, args)
    hit = tp < BIG_T
    assert_hits_match(got["t"], perm[np.maximum(got["slot"], 0)], tp, hit,
                      perm[ip], o, d, tris)
    np.testing.assert_array_equal(got["slot"][~hit], -1)
    same = hit & (got["slot"] == ip)
    np.testing.assert_allclose(got["u"][same], up[same], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["v"][same], vp[same], rtol=1e-4,
                               atol=1e-5)
    tx, _, _, ix = (np.asarray(x) for x in xla_cluster_closest(
        jnp.asarray(o), jnp.asarray(d), *args[:3],
        jnp.asarray(grid.aabb_min), jnp.asarray(grid.aabb_max)))
    assert_hits_match(got["t"], perm[np.maximum(got["slot"], 0)], tx,
                      tx < BIG_T, perm[ix], o, d, tris)


def test_cluster_t_limit_shadow_and_dead_rays():
    """Below a t limit the hit is exact (beyond it unspecified); the
    intersector's shadow is closest-then-window with limit 1.0; dead
    rays (alive False, or sentinel origins) miss."""
    tris = random_scene(900, seed=13)
    o, d = random_rays(1024, seed=14)
    grid, port, args = _cluster(tris)
    brute = jax_closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris))
    bt = np.asarray(brute["t"])
    limit = float(np.median(bt[bt < BIG_T]))
    tl = _pallas(o, d, args, t_limit=limit)[0]
    got = _plain(port, o, d)
    below = bt <= limit * 0.999
    np.testing.assert_allclose(got["t"][below], tl[below], rtol=1e-5,
                               atol=T_ATOL)
    np.testing.assert_allclose(got["t"][below], bt[below], rtol=1e-5,
                               atol=T_ATOL)

    alive = np.ones(1024, bool)
    alive[100:200] = False
    o2, d2 = o.copy(), d.copy()
    o2[900:] = DEAD_ORIGIN
    d2[900:] = 1.0
    alive_t = _t(alive)
    q = port.query(None, _t(o2), _t(d2), alive=alive_t)
    sh = port.shadow(None, _t(o2), _t(d2), alive=alive_t).numpy()
    t1 = _pallas(o2, d2, args, t_limit=1.0)[0]
    live = alive.copy()
    live[900:] = False
    assert not q["hit"].numpy()[~live].any() and not sh[~live].any()
    assert (q["slot"].numpy()[~live] == 0).all()
    want_sh = (t1 < BIG_T) & (t1 > 0.01) & (t1 < 1.0)
    np.testing.assert_array_equal(sh[live], want_sh[live])
    bhit = np.asarray(brute["hit"])
    assert_hits_match(q["t"].numpy(), q["tri"].numpy(), bt, bhit,
                      np.asarray(brute["tri"]), o, d, tris, mask=live)


def test_cluster_axis_parallel_rays():
    """Zero direction components: the cluster kernel inverts raw (1/0 =
    inf), and an origin on a box plane gives NaN slab distances, which
    cull the cluster.  The TPU kernel culls per 128-ray block, the port
    per ray, so each ray here sits alone in its block (the others dead):
    then the two are the same function, and rays 1-3 and 5, which start
    on a plane of the quad's box, miss in both."""
    tris = np.array([
        [[0, 0, 1], [1, 0, 1], [0, 1, 1]],
        [[1, 0, 1], [1, 1, 1], [0, 1, 1]],
    ], np.float32)
    o7 = np.array([[0.25, 0.25, 0.0], [0.0, 0.25, 0.0], [0.0, 0.0, 0.0],
                   [1.0, 1.0, 0.0], [2.0, 0.25, 0.0], [0.25, 0.25, 1.0],
                   [0.5, 0.5, 3.0]], np.float32)
    d7 = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1],
                   [1, 0, 0], [0, 0, -1]], np.float32)
    at = 128 * np.arange(len(o7))
    o = np.full((1024, 3), DEAD_ORIGIN, np.float32)
    d = np.ones((1024, 3), np.float32)
    o[at], d[at] = o7, d7
    grid, port, args = _cluster(tris)
    want = _pallas(o, d, args)[0]
    got = _plain(port, o, d)["t"]
    assert not np.isnan(want).any() and not np.isnan(got).any()
    np.testing.assert_array_equal(got < BIG_T, want < BIG_T)
    hit = want < BIG_T
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-6)
    np.testing.assert_allclose(got[at], [1.0, BIG_T, BIG_T, BIG_T, BIG_T,
                                         BIG_T, 2.0], rtol=1e-6)
    assert hit.sum() == 2


def test_cpu_call_leaves_the_cluster_launch_count_alone():
    before = cuda_cluster.cluster_closest.launches
    tris = random_scene(50, seed=3)
    _, port, _ = _cluster(tris)
    o, d = random_rays(16, seed=4)
    port.query(None, _t(o), _t(d))
    assert cuda_cluster.cluster_closest.launches == before
    assert isinstance(before, int)
