"""The port's CUDA kernels themselves, on the card: each against its
plain PyTorch version on the same inputs, and the slab-test cases that
the per-ray walks take differently from the TPU kernels' block walks.
Every test needs an NVIDIA card and skips without one.

This file imports neither JAX nor the reference package, so it runs on
a machine without them; the repo's conftest imports JAX, hence:

    python -m pytest --noconftest -q -m cuda tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.intersect import BIG_T
from raytracer_tpu_torch.ops import cuda_bvh, cuda_cluster
from raytracer_tpu_torch.ops.cuda_bvh import BVHIntersector, rays_from
from raytracer_tpu_torch.ops.cuda_cluster import ClusterIntersector

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class _Buffers:
    def __init__(self, tris):
        self.tri_verts = tris


# a unit quad in the z=1 plane over [0,1]x[0,1]
# (tests/test_pallas_bvh.py::test_bvh_axis_parallel_rays_zero_direction)
QUAD = np.array([[[0, 0, 1], [1, 0, 1], [0, 1, 1]],
                 [[1, 0, 1], [1, 1, 1], [0, 1, 1]]], np.float32)
O = np.array([[0.25, 0.25, 0.0],   # straight +z hit
              [0.0, 0.25, 0.0],    # on the x=0 (min) box plane, dx=0
              [0.0, 0.0, 0.0],     # on both min planes
              [1.0, 1.0, 0.0],     # on both MAX planes
              [2.0, 0.25, 0.0],    # outside the slab: miss
              [0.25, 0.25, 1.0],   # in the z=1 plane, grazing: miss
              [0.5, 0.5, 3.0]], np.float32)
D = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1],
              [1, 0, 0], [0, 0, -1]], np.float32)


def _both(make, card):
    """The intersector on the card and on the CPU (plain versions)."""
    return make(card), make("cpu")


def test_bvh_kernels_take_axis_parallel_rays_in_box_faces(card):
    """A ray parallel to a slab and lying in a box face is inside the
    slab: rays 1-3 (min and max faces) hit at t = 1 in the closest and
    the spawn kernels, as the reference test expects of the TPU kernel
    and as the dense plain versions find."""
    gpu, cpu = _both(lambda dev: BVHIntersector(_Buffers(QUAD), device=dev),
                     card)
    got = gpu.query(None, torch.from_numpy(O).to(card),
                    torch.from_numpy(D).to(card))["t"].cpu().numpy()
    want = cpu.query(None, torch.from_numpy(O), torch.from_numpy(D))["t"]
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_allclose(got[:4], 1.0, rtol=1e-6)
    assert (got[4:6] == np.float32(BIG_T)).all() and got[6] == 2.0
    rec = torch.ones((6, gpu.packed.num_slots), device=card)
    rays = rays_from(torch.from_numpy(O), torch.from_numpy(D)).to(card)
    spawn = cuda_bvh.bvh_spawn(
        rays, torch.zeros((0, len(O)), device=card),
        torch.tensor([[0.5, 0.5, 5.0]], device=card), gpu.packed, rec,
        world_lo=gpu.world_lo, world_inv_span=gpu.world_inv_span,
        children=0, emit_uv=False)
    np.testing.assert_array_equal(spawn["t"].cpu().numpy(), got)


def test_cluster_kernel_culls_nan_slabs_per_ray(card):
    """The cluster kernel inverts raw: a zero component meeting an origin
    on a box plane gives NaN, and the cluster is culled for that ray
    (rays 1-3), as the plain version culls the same pairs."""
    gpu, cpu = _both(
        lambda dev: ClusterIntersector(_Buffers(QUAD), device=dev), card)
    got = gpu.query(None, torch.from_numpy(O).to(card),
                    torch.from_numpy(D).to(card))["t"].cpu().numpy()
    want = cpu.query(None, torch.from_numpy(O), torch.from_numpy(D))["t"]
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got[1:6], np.float32(BIG_T))
    assert got[0] == 1.0 and got[6] == 2.0


def _random(n_tris=3000, n_rays=4096, seed=5):
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-5, 5, (n_tris, 1, 3))
            + rng.uniform(-0.8, 0.8, (n_tris, 3, 3))).astype(np.float32)
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    o[::7] = 1e35                       # scattered dead rays
    return tris, torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_closest_kernels_match_plain(card, kind):
    """Closest hit and the (0.01, 1.0) shadow window on a random scene:
    t equal bit for bit (--fmad=false), slots equal except exact-t
    ties, launch counts raised once per kernel call."""
    tris, o, d = _random()
    cls = BVHIntersector if kind == "bvh" else ClusterIntersector
    gpu, cpu = _both(lambda dev: cls(_Buffers(tris), device=dev), card)
    wrapper = (cuda_bvh.bvh_closest if kind == "bvh"
               else cuda_cluster.cluster_closest)
    before = wrapper.launches
    got = gpu.query(None, o.to(card), d.to(card))
    blocked = gpu.shadow(None, o.to(card), d.to(card)).cpu()
    assert wrapper.launches == before + 2
    want = cpu.query(None, o, d)
    t = got["t"].cpu()
    np.testing.assert_array_equal(t.numpy(), want["t"].numpy())
    hit = want["hit"]
    assert hit.any()
    same = got["slot"].cpu() == want["slot"]
    assert int((hit & ~same).sum()) <= 1
    np.testing.assert_array_equal(blocked.numpy(),
                                  cpu.shadow(None, o, d).numpy())


# --- the fused kernels' block walk ------------------------------------------
#
# bvh_spawn and bvh_shadow_shade walk per block of 128 rays (the live
# rays of a window of 512, packed to the front) and stage each row the
# block needs in shared memory, chunk by chunk of 128 lanes.
# Each case below holds both kernels against their plain versions on the
# same card tensors: t, records, u/v, shadow rays, child rays and keys
# equal bit for bit (--fmad=false), except that an exact-t tie across
# rows may pick another triangle (at most MAX_TIES rays of a case).

MAX_TIES = 1


def _fused(card, tris, tpl=128, n_rec=6, seed=0, textured=None):
    """A BVH intersector on the card with random shading records: "full"
    records of `n_rec` planes, or with `textured` given, "mat" records
    (4 planes, the last a material id in 0..4)."""
    isect = BVHIntersector(_Buffers(tris), triangles_per_leaf=tpl,
                           device=card)
    rng = np.random.default_rng(seed)
    if textured is not None:
        n_rec = 4
    rec = rng.uniform(-1, 1, (isect.packed.num_slots, n_rec))
    if textured is not None:
        rec[:, 3] = rng.integers(0, 5, isect.packed.num_slots)
        isect.set_shade_records(torch.from_numpy(rec.astype(np.float32)),
                                fmt="mat", textured=textured)
        return isect
    if n_rec == 7:
        rec[:, 6] = -1.0                     # texture id: none
    isect.set_shade_records(torch.from_numpy(rec.astype(np.float32)))
    return isect


def _fused_check(card, isect, o, d, b=1, L=1, seed=1):
    """Both fused kernels against their plain versions on rays (o, d);
    returns the spawn outputs and each kernel's per-ray row counter."""
    rng = np.random.default_rng(seed)
    R = o.shape[0]
    rays = rays_from(o, d).to(card)
    g = torch.from_numpy(rng.standard_normal((3 * b, R),
                                             dtype=np.float32)).to(card)
    lp = torch.from_numpy(rng.uniform(-6, 6, (L, 3)).astype(np.float32))
    lp = lp.to(card)
    planes = isect.shade_planes
    kw = dict(world_lo=isect.world_lo, world_inv_span=isect.world_inv_span,
              children=b, emit_uv=isect.fused_has_textures, key_mode="dir6")
    rows = torch.full((R,), -1, dtype=torch.int32, device=card)
    got = cuda_bvh.bvh_spawn(rays, g, lp, isect.packed, planes,
                             tests_out=rows, **kw)
    want = cuda_bvh.bvh_spawn_plain(rays, g, lp, isect.packed, planes, **kw)
    assert torch.equal(got["t"], want["t"])
    ties = (got["rec"] != want["rec"]).any(0)
    assert int(ties.sum()) <= MAX_TIES
    same = ~ties
    assert torch.equal(got["shadow"].view(6, L, R)[:, :, same],
                       want["shadow"].view(6, L, R)[:, :, same])
    if b:
        assert torch.equal(got["children"].view(6, R, b)[:, same],
                           want["children"].view(6, R, b)[:, same])
        assert torch.equal(got["keys"].view(R, b)[same],
                           want["keys"].view(R, b)[same])
    if "u" in want:
        assert torch.equal(got["u"][same], want["u"][same])
        assert torch.equal(got["v"][same], want["v"][same])
    lc = torch.from_numpy(rng.uniform(0.2, 1, (L, 3)).astype(np.float32))
    if isect.rec_format == "mat":
        # the wavefront's gather of a per-material colour table
        table = torch.from_numpy(rng.uniform(0, 1, (5, 3)).astype(
            np.float32)).to(card)
        color = table[got["rec"][3].long()].t().contiguous()
    else:
        color = got["rec"][3:6]
    args = (got["shadow"], got["rec"][0:3], color, rays[3:6], lc.to(card))
    rows_sh = torch.full((L * R,), -1, dtype=torch.int32, device=card)
    rad = cuda_bvh.bvh_shadow_shade(*args, isect.packed, tests_out=rows_sh)
    assert torch.equal(rad, cuda_bvh.bvh_shadow_shade_plain(*args,
                                                            isect.packed))
    assert bool((rows >= 0).all()) and bool((rows_sh >= 0).all())
    return got, rows, rows_sh


def _dead(o, d, idx):
    o, d = o.clone(), d.clone()
    o[idx] = 1e35
    d[idx] = 1.0
    return o, d


@pytest.mark.parametrize("case", ["dead_block", "mixed", "ragged"])
def test_fused_kernels_dead_and_ragged_blocks(card, case):
    """A block whose window of 512 rays is all dead walks nothing (no
    test counted, every output dead); windows that mix dead and live
    rays; a ray count that is not a multiple of the block or window."""
    tris, o, d = _random(n_rays=1001 if case == "ragged" else 4096)
    if case == "dead_block":
        o, d = _dead(o, d, slice(512, 1024))
    elif case == "mixed":
        o, d = _dead(o, d, slice(None, None, 3))
    isect = _fused(card, tris)
    got, rows, rows_sh = _fused_check(card, isect, o, d, b=1)
    alive = (o[:, 0].abs() < 1e30).to(card)
    assert bool((got["t"][~alive] == np.float32(BIG_T)).all())
    assert bool((got["keys"][~alive] == 2 ** 30).all())
    assert bool((got["t"][alive] < np.float32(BIG_T)).any())
    if case == "dead_block":
        assert int(rows[512:1024].sum()) == 0
        assert int(rows_sh[512:1024].sum()) == 0
        assert int(rows.sum()) > 0


def _two_sides(R=512, seed=7):
    """Two heaps of triangles far apart on the x axis, and R rays whose
    neighbours alternate between them: a block needs two disjoint sets of
    rows (or clusters)."""
    rng = np.random.default_rng(seed)
    n = 1500
    centers = np.zeros((2 * n, 1, 3))
    centers[:n, 0, 0], centers[n:, 0, 0] = -40.0, 40.0
    tris = (centers + rng.uniform(-3, 3, (2 * n, 1, 3))
            + rng.uniform(-0.7, 0.7, (2 * n, 3, 3))).astype(np.float32)
    side = np.where(np.arange(R) % 2 == 0, -40.0, 40.0)[:, None]
    o = np.concatenate([side[:, :1], np.zeros((R, 1)), np.full((R, 1), -20.0)],
                       axis=1) + rng.uniform(-2, 2, (R, 3))
    d = np.concatenate([rng.uniform(-0.05, 0.05, (R, 2)), np.ones((R, 1))],
                       axis=1)
    return (tris, torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def test_fused_kernels_rays_needing_disjoint_rows(card):
    """Two clusters of triangles far apart, and one block whose rays
    alternate between them: the block's row list is the union of two
    disjoint sets, and each ray still gets its own closest hit."""
    tris, o, d = _two_sides()
    isect = _fused(card, tris)
    got, rows, _ = _fused_check(card, isect, o, d, b=0)
    hit = got["t"] < np.float32(BIG_T)
    assert bool(hit[0::2].any()) and bool(hit[1::2].any())
    # the rows a ray of each cluster needs lie in its own half of the BVH
    need = cuda_bvh.bvh_tests_needed(rays_from(o, d).to(card),
                                     isect.packed)["rows"]
    assert int(need.sum()) > 0 and int(rows.sum()) > 0


@pytest.mark.parametrize("tpl", [128, 256, 384])
def test_fused_kernels_stage_every_row_width(card, tpl):
    """C = 128, 256 and 384 lanes a row: one, two and three staged
    chunks, so the double buffer wraps mid-row."""
    tris, o, d = _random()
    isect = _fused(card, tris, tpl=tpl)
    assert isect.packed.C == tpl
    _fused_check(card, isect, o, d, b=1)


def test_fused_kernels_two_lights_two_children(card):
    tris, o, d = _random()
    _fused_check(card, _fused(card, tris), o, d, b=2, L=2)


def test_fused_kernels_textured_emit_uv(card):
    """Seven record planes: the spawn kernel also keeps u and v."""
    tris, o, d = _random()
    got, _, _ = _fused_check(card, _fused(card, tris, n_rec=7), o, d, b=1)
    assert got["rec"].shape[0] == 7 and "u" in got


def test_fused_kernels_axis_parallel_quad(card):
    """The reference's quad case through both fused kernels: the rays
    lying in box faces hit at t = 1, and the same rays as shadow rays
    (direction doubled, so the quad lies at t = 0.5) are blocked."""
    isect = _fused(card, QUAD)
    o, d = torch.from_numpy(O), torch.from_numpy(D)
    got, _, _ = _fused_check(card, isect, o, d, b=1)
    np.testing.assert_allclose(got["t"][:4].cpu().numpy(), 1.0, rtol=1e-6)
    shadow = rays_from(o, 2 * d).to(card)
    R = len(O)
    planes = torch.ones((3, R), device=card)
    args = (shadow, planes, planes, planes, torch.ones((1, 3), device=card))
    rad = cuda_bvh.bvh_shadow_shade(*args, isect.packed)
    assert torch.equal(rad, cuda_bvh.bvh_shadow_shade_plain(*args,
                                                            isect.packed))
    assert bool((rad[:, :4] == 0).all()) and bool((rad[:, 4:] != 0).any())


def test_shadow_shade_window_edges(card):
    """Occluders at t exactly 0.01 and 1.0 do not block (the window is
    open); t just inside it does.  A quad at z = 1 under shadow rays from
    z = 0 with dz = 100, 99, 1.5, 1 and 0.999: t = 1/dz."""
    isect = _fused(card, QUAD)
    dz = np.array([100.0, 99.0, 1.5, 1.0, 0.999], np.float32)
    R = len(dz)
    o = np.tile(np.float32([0.25, 0.25, 0.0]), (R, 1))
    d = np.stack([np.zeros(R), np.zeros(R), dz], 1).astype(np.float32)
    shadow = rays_from(torch.from_numpy(o), torch.from_numpy(d)).to(card)
    t = cuda_bvh.bvh_closest(shadow, isect.packed, shadow=True)["t"]
    assert t[0] == np.float32(0.01) and t[3] == np.float32(1.0)
    normal = torch.tensor([[0.0], [0.0], [1.0]], device=card).expand(3, R)
    args = (shadow, normal.contiguous(), torch.ones((3, R), device=card),
            torch.ones((3, R), device=card), torch.ones((1, 3), device=card))
    rad = cuda_bvh.bvh_shadow_shade(*args, isect.packed)
    assert torch.equal(rad, cuda_bvh.bvh_shadow_shade_plain(*args,
                                                            isect.packed))
    lit = (rad != 0).any(0).cpu().numpy()
    np.testing.assert_array_equal(lit, [True, False, False, True, True])


def _bare(card, C=256, G=8, S=4, K1=2, offset=0):
    """A BVH of zeros on the card with the given shape; `offset` floats
    shift the triangle planes off 16-byte alignment."""
    NL = K1 * G
    tri = torch.zeros(9 * NL * C + offset, device=card)[offset:]
    return cuda_bvh.PackedBVH(
        tri=tri.view(9, NL * C),
        seg_aabb=torch.zeros((NL * S, 8), device=card),
        sc_aabb=torch.zeros((K1, 8), device=card),
        orders=torch.zeros((6, K1), dtype=torch.int32, device=card),
        C=C, S=S, G=G)


@pytest.mark.parametrize("kw,block", [
    (dict(C=192), 128),          # C not a multiple of the 128-lane chunk
    (dict(G=33), 128),           # more rows than a 32-bit row mask
    (dict(S=3), 128),            # segments that do not divide C
    (dict(), 100),               # a block of partial warps
    (dict(), 512),               # past __launch_bounds__
    (dict(offset=1), 128),       # planes cp.async cannot copy
    (dict(S=256), 256),          # more shared memory than a block has
])
def test_fused_kernels_raise_on_shapes_they_do_not_take(card, kw, block):
    """The fused wrappers raise on every shape the block walk refuses
    (walk_config) and count no launch; the next launch still works."""
    bvh = _bare(card, **kw)
    R = 64
    rays = torch.zeros((6, R), device=card)
    before = (cuda_bvh.bvh_spawn.launches, cuda_bvh.bvh_shadow_shade.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_bvh.bvh_spawn(rays, torch.zeros((0, R), device=card),
                           torch.zeros((1, 3), device=card), bvh,
                           torch.zeros((6, bvh.num_slots), device=card),
                           world_lo=(0.0,) * 3, world_inv_span=(1.0,) * 3,
                           children=0, emit_uv=False, ray_block=block)
    planes = torch.zeros((3, R), device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_bvh.bvh_shadow_shade(rays, planes, planes, planes,
                                  torch.zeros((1, 3), device=card), bvh,
                                  ray_block=block)
    assert (cuda_bvh.bvh_spawn.launches,
            cuda_bvh.bvh_shadow_shade.launches) == before
    tris, o, d = _random(n_rays=512)
    _fused_check(card, _fused(card, tris), o, d, b=0)


@pytest.mark.parametrize("seg", [1, 4])
def test_closest_lanes_counter(card, seg):
    """bvh_tests_needed's lanes count, within the rows its per-ray walk
    tests, the lanes of the segments a ray enters before its best t: a
    row of one segment counts whole; else each tested row counts between
    one segment and all of its lanes, whole segments, and some segments
    are skipped.  The counting walk's t equals the block walk's below the
    limit, and its slots differ only on exact-t ties."""
    tris, o, d = _random()
    isect = BVHIntersector(_Buffers(tris), seg=seg, device=card)
    C, S = isect.packed.C, isect.packed.S
    assert S == seg
    rays = rays_from(o, d).to(card)
    for limit, shadow in ((None, False), (1.0, True)):
        n = cuda_bvh.bvh_tests_needed(rays, isect.packed, t_limit=limit)
        rows, lanes = n["rows"], n["lanes"]
        got = cuda_bvh.bvh_closest(rays, isect.packed, t_limit=limit,
                                   shadow=shadow)
        below = n["t"] < (BIG_T if limit is None else limit)
        assert torch.equal(got["t"][below], n["t"][below])
        if not shadow:
            assert int((got["slot"] != n["slot"]).sum()) <= MAX_TIES
        dead = (rays[0].abs() >= 1e30)
        assert int(rows[dead].sum()) == 0 and int(lanes[dead].sum()) == 0
        if S == 1:
            assert torch.equal(lanes, rows * C)
        else:
            assert bool((lanes % (C // S) == 0).all())
            assert bool((lanes >= rows * (C // S)).all())
            assert bool((lanes <= rows * C).all())
            assert int(lanes.sum()) < int(rows.sum()) * C


# --- the closest-hit kernels' block walks ------------------------------------
#
# bvh_closest runs the fused kernels' block walk; cluster_closest a block
# walk of the same shape over the flat grid (csrc/cuda_cluster.cu).  Each
# case holds a kernel against its plain version on the same card tensors:
# t equal bit for bit below the t limit (and never below the dense t past
# it), slots, u/v and records equal except on exact-t ties across rows or
# clusters (at most MAX_TIES rays of a case).


def _isect(card, kind, tris, **kw):
    cls = BVHIntersector if kind == "bvh" else ClusterIntersector
    return cls(_Buffers(tris), device=card, **kw)


def _closest_check(card, kind, isect, rays, t_limit=None, shadow=False,
                   rec=None, ray_block=128):
    """One closest-hit kernel against its plain version on `rays`;
    returns (kernel outputs, plain outputs, per-ray tests run)."""
    R = rays.shape[1]
    tests = torch.full((R,), -1, dtype=torch.int32, device=card)
    if kind == "bvh":
        got = cuda_bvh.bvh_closest(rays, isect.packed, rec, t_limit=t_limit,
                                   shadow=shadow, ray_block=ray_block,
                                   tests_out=tests)
        want = cuda_bvh.bvh_closest_plain(rays, isect.packed, rec,
                                          shadow=shadow)
    else:
        got = cuda_cluster.cluster_closest(rays, isect.packed,
                                           t_limit=t_limit,
                                           ray_block=ray_block,
                                           tests_out=tests)
        want = cuda_cluster.cluster_closest_plain(rays, isect.packed)
    assert set(got) == set(want)
    below = want["t"] < (BIG_T if t_limit is None else t_limit)
    assert bool((got["t"] >= want["t"]).all())
    assert torch.equal(got["t"][below], want["t"][below])
    if "slot" in want:
        ties = below & (got["slot"] != want["slot"])
        assert int(ties.sum()) <= MAX_TIES
        same = below & ~ties
        for k in ("slot", "u", "v"):
            assert torch.equal(got[k][same], want[k][same]), k
        if rec is not None:
            assert torch.equal(got["rec"][:, same], want["rec"][:, same])
    assert bool((tests >= 0).all())
    return got, want, tests


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
@pytest.mark.parametrize("case", ["dead_block", "mixed", "ragged",
                                  "block256"])
def test_closest_kernels_dead_and_ragged_windows(card, kind, case):
    """A window of 512 rays that is all dead walks nothing (no test
    counted, every ray a miss); windows that mix dead and live rays; a
    ray count that is not a multiple of the window; blocks of 256
    threads (their shared memory opted in past the default)."""
    tris, o, d = _random(n_rays=1001 if case == "ragged" else 4096)
    if case == "dead_block":
        o, d = _dead(o, d, slice(512, 1024))
    elif case == "mixed":
        o, d = _dead(o, d, slice(None, None, 3))
    isect = _isect(card, kind, tris)
    rays = rays_from(o, d).to(card)
    block = 256 if case == "block256" else 128
    for shadow in (False, True):
        got, _, tests = _closest_check(
            card, kind, isect, rays, t_limit=1.0 if shadow else None,
            shadow=shadow and kind == "bvh", ray_block=block)
        alive = (o[:, 0].abs() < 1e30).to(card)
        assert bool((got["t"][~alive] == np.float32(BIG_T)).all())
        assert bool((got["t"][alive] < np.float32(BIG_T)).any())
        if case == "dead_block":
            assert int(tests[512:1024].sum()) == 0
            assert int(tests.sum()) > 0


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_closest_kernels_rays_needing_disjoint_parts(card, kind):
    """Neighbouring rays that need rows (or clusters) far apart: the
    block stages the union, and each ray still gets its own hit."""
    tris, o, d = _two_sides()
    got, _, _ = _closest_check(card, kind, _isect(card, kind, tris),
                               rays_from(o, d).to(card))
    hit = got["t"] < np.float32(BIG_T)
    assert bool(hit[0::2].any()) and bool(hit[1::2].any())


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_closest_kernels_t_limit_and_shadow(card, kind):
    """A t limit at the median hit: exact below it; the (0.01, 1.0)
    shadow window through the intersector equals the plain version's;
    bvh_closest's shadow mode returns t alone."""
    tris, o, d = _random()
    isect = _isect(card, kind, tris)
    rays = rays_from(o, d).to(card)
    _, want, _ = _closest_check(card, kind, isect, rays)
    hit_t = want["t"][want["t"] < BIG_T]
    _closest_check(card, kind, isect, rays, t_limit=float(hit_t.median()))
    if kind == "bvh":
        got, _, _ = _closest_check(card, kind, isect, rays, t_limit=1.0,
                                   shadow=True)
        assert set(got) == {"t"}
    cpu = _isect("cpu", kind, tris)
    np.testing.assert_array_equal(
        isect.shadow(None, o.to(card), d.to(card)).cpu().numpy(),
        cpu.shadow(None, o, d).numpy())


@pytest.mark.parametrize("n_rec", [6, 7])
def test_bvh_closest_record_planes(card, n_rec):
    """The winning triangle's 6 or 7 record values, 0 on a miss, as the
    composable wavefront's emit_shade query takes them."""
    tris, o, d = _random()
    isect = _fused(card, tris, n_rec=n_rec)
    got, _, _ = _closest_check(card, "bvh", isect, rays_from(o, d).to(card),
                               rec=isect.shade_planes)
    assert got["rec"].shape == (n_rec, o.shape[0])
    miss = got["t"] == np.float32(BIG_T)
    assert bool(miss.any()) and bool((got["rec"][:, miss] == 0).all())


@pytest.mark.parametrize("tpl,C", [(70, 128), (256, 256)])
def test_cluster_kernel_stages_every_cluster_width(card, tpl, C):
    """C = 128 and 256 lanes a cluster: one and two staged chunks."""
    tris, o, d = _random()
    isect = _isect(card, "cluster", tris, triangles_per_leaf=tpl)
    assert isect.packed.C == C
    _closest_check(card, "cluster", isect, rays_from(o, d).to(card))


def test_cluster_kernel_culls_nan_slabs_per_ray_under_the_warp_union(card):
    """Rays lying on a plane of the quad's box with a zero direction
    component (rays 1-3 of O: a NaN slab entry) among 121 rays of the
    same window and warps that enter the cluster and hit it at t = 1:
    their warps test the cluster, yet they take no hit from it, as the
    plain version culls them."""
    rng = np.random.default_rng(3)
    R = 128
    o = np.zeros((R, 3), np.float32)
    o[:, :2] = rng.uniform(0.05, 0.95, (R, 2))
    d = np.tile(np.float32([0, 0, 1]), (R, 1))
    plane = np.array([5, 6, 37, 70, 71, 100, 127])
    o[plane] = O[[1, 2, 3, 1, 2, 3, 1]]
    isect = _isect(card, "cluster", QUAD)
    got, want, _ = _closest_check(card, "cluster", isect, rays_from(
        torch.from_numpy(o), torch.from_numpy(d)).to(card))
    assert torch.equal(got["slot"], want["slot"])
    t = got["t"].cpu().numpy()
    assert (t[plane] == np.float32(BIG_T)).all()
    enter = np.setdiff1d(np.arange(R), plane)
    assert len(enter) >= 100 and (t[enter] == 1.0).all()


def _bare_grid(card, C=128, K=2, offset=0):
    """A cluster grid of zeros on the card with the given shape."""
    tri = torch.zeros(9 * K * C + offset, device=card)[offset:]
    return cuda_cluster.PackedGrid(
        tri=tri.view(9, K * C), aabb=torch.zeros((K, 8), device=card),
        orders=torch.zeros((6, K), dtype=torch.int32, device=card), C=C)


@pytest.mark.parametrize("kind,kw,block", [
    ("bvh", dict(C=192), 128),       # C not a multiple of the chunk
    ("bvh", dict(G=33), 128),        # more rows than a 32-bit row mask
    ("bvh", dict(S=3), 128),         # segments that do not divide C
    ("bvh", dict(), 100),            # a block of partial warps
    ("bvh", dict(), 512),            # past __launch_bounds__
    ("bvh", dict(offset=1), 128),    # planes cp.async cannot copy
    ("bvh", dict(G=0), 128),         # superclusters of no rows
    ("cluster", dict(C=192), 128),
    ("cluster", dict(C=64), 128),
    ("cluster", dict(), 100),
    ("cluster", dict(), 512),
    ("cluster", dict(offset=1), 128),
])
def test_closest_kernels_raise_on_shapes_they_do_not_take(card, kind, kw,
                                                          block):
    """bvh_closest (walk_config) and cluster_closest (walk_takes) raise on
    every shape their block walk refuses and count no launch; the next
    launch still works."""
    rays = torch.zeros((6, 64), device=card)
    if kind == "bvh":
        wrapper = cuda_bvh.bvh_closest
        packed = _bare(card, **kw)
    else:
        wrapper = cuda_cluster.cluster_closest
        packed = _bare_grid(card, **kw)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        wrapper(rays, packed, ray_block=block)
    assert wrapper.launches == before
    tris, o, d = _random(n_rays=512)
    _closest_check(card, kind, _isect(card, kind, tris),
                   rays_from(o, d).to(card))
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_tests_run_cover_tests_needed(card, kind):
    """On the same rays, the block walk's warps run at least the tests
    that the per-ray counting walk needs (each warp tests the union of its
    rays' needs), and the counting walk's closest t is the block walk's
    below the limit."""
    tris, o, d = _random()
    isect = _isect(card, kind, tris)
    rays = rays_from(o, d).to(card)
    for limit in (None, 1.0):
        got, _, run = _closest_check(card, kind, isect, rays, t_limit=limit)
        if kind == "bvh":
            n = cuda_bvh.bvh_tests_needed(rays, isect.packed, t_limit=limit)
            need = n["lanes"]
        else:
            n = cuda_cluster.cluster_tests_needed(rays, isect.packed,
                                                  t_limit=limit)
            need = n["clusters"] * isect.packed.C
        assert int(run.sum()) >= int(need.sum()) > 0
        below = n["t"] < (BIG_T if limit is None else limit)
        assert torch.equal(got["t"][below], n["t"][below])
        assert int((below & (got["slot"] != n["slot"])).sum()) <= MAX_TIES


# "mat" records: 4 planes [normal, material id]; the epilogue reads the
# normal only, so the kernels take them unchanged, with u/v when textured.

@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("case", ["mixed", "ragged", "disjoint", "tpl256",
                                  "lights2_children2"])
def test_fused_kernels_mat_records(card, case, textured):
    """Both fused kernels with 4 "mat" record planes against their plain
    versions on the risky shapes above: dead rays mixed in, a ragged ray
    count, rays needing disjoint rows, two staged chunks a row, two
    lights and two children."""
    b, L, tpl = 1, 1, 128
    if case == "disjoint":
        tris, o, d = _two_sides()
        b = 0
    else:
        tris, o, d = _random(n_rays=1001 if case == "ragged" else 4096)
    if case == "mixed":
        o, d = _dead(o, d, slice(None, None, 3))
    elif case == "tpl256":
        tpl = 256
    elif case == "lights2_children2":
        b, L = 2, 2
    isect = _fused(card, tris, tpl=tpl, textured=textured)
    assert isect.supports_fused_spawn and not isect.supports_fused_shade
    assert isect.fused_has_textures == textured
    got, _, _ = _fused_check(card, isect, o, d, b=b, L=L)
    assert got["rec"].shape[0] == 4 and ("u" in got) == textured
    hit = got["t"] < np.float32(BIG_T)
    assert bool(hit.any())
    mid = got["rec"][3][hit]
    assert bool(((mid >= 0) & (mid < 5) & (mid == mid.round())).all())


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_kernel_intersector_gradients_on_the_card(card, kind):
    """Under autograd a query launches its kernel once: t, u and v equal
    the no_grad query's bit for bit, and the rays' gradients (through
    the winner's recomputed Moller-Trumbore) equal the CPU's, zero and
    finite on the dead and missed rays.  A BVH query with emit_shade
    still raises under autograd and launches nothing."""
    tris, o, d = _random(n_rays=1024)
    o[::7] = 0.0                        # finite origins; dead by alive
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    alive[::7] = False
    grads = {}
    for dev in (card, "cpu"):
        isect = _isect(dev, kind, tris)
        wrapper = (cuda_bvh.bvh_closest if kind == "bvh"
                   else cuda_cluster.cluster_closest)
        og, dg = (a.to(dev).requires_grad_(True) for a in (o, d))
        before = wrapper.launches
        got = isect.query(None, og, dg, alive=alive.to(dev))
        with torch.no_grad():
            want = isect.query(None, og, dg, alive=alive.to(dev))
        if dev == card:
            assert wrapper.launches == before + 2
        for k in ("t", "u", "v"):
            assert torch.equal(got[k].detach().view(torch.int32),
                               want[k].view(torch.int32)), k
        hit = got["hit"]
        assert bool(hit.any()) and not bool(hit[alive.to(dev) == 0].any())
        (got["t"][hit].sum() + got["u"].sum() + got["v"].sum()).backward()
        for g in (og.grad, dg.grad):
            assert bool(torch.isfinite(g).all()) and bool((g[~hit] == 0).all())
        grads[str(dev)] = (og.grad.cpu(), dg.grad.cpu(), hit.cpu())
        if kind == "bvh":
            isect.set_shade_records(torch.ones((isect.packed.num_slots, 6)))
            before = wrapper.launches
            with pytest.raises(ValueError, match="emit_shade"):
                isect.query(None, og, dg, emit_shade=True)
            if dev == card:
                assert wrapper.launches == before
    (go, gd, hk), (co, cd, hc) = grads[str(card)], grads["cpu"]
    assert torch.equal(hk, hc)
    for g, c in ((go, co), (gd, cd)):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(c.abs().max()))


class _NumpyDraws:
    """Draws from a seeded numpy generator: the same numbers on any
    device."""

    def __init__(self, seed, device):
        self.rng = np.random.default_rng(seed)
        self.device = device

    def next_sample(self, n):
        return (torch.from_numpy(self.rng.random((n, 2), dtype=np.float32))
                .to(self.device), self)

    def normal(self, level, n):
        return torch.from_numpy(self.rng.standard_normal(
            (n, 3), dtype=np.float32)).to(self.device)


def test_inverse_rendering_step_on_the_card_matches_the_cpu(card):
    """One train step of inverse rendering (ico3_tex at 64x64, 2 bounces,
    brute force): from the same perturbed start and the same draws, the
    loss and the gradients of the optimized leaves on the card equal the
    CPU's to the CPU tests' tolerance (rtol 1e-3, atol 1e-5 of the
    largest entry; only the gradient sums' order differs)."""
    import pathlib
    from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
    from raytracer_tpu_torch.diff.gradients import render_pixels
    from raytracer_tpu_torch.diff.inverse import (extract_params,
                                                  make_train_step,
                                                  merge_params)
    from raytracer_tpu_torch.models.collada import ColladaLoader
    W = H = 64
    scene = ColladaLoader.from_file(
        pathlib.Path(__file__).resolve().parent.parent / "data"
        / "ico3_tex.dae", width=W, height=H, verbose=False)
    rng = np.random.default_rng(0)
    noise = rng.standard_normal(scene.to_buffers().tri_verts.shape)
    out = {}
    for dev in (card, torch.device("cpu")):
        sa = scene.to_buffers().to_device(dev)
        cam = scene.cameras[0].params(dev)
        px = torch.arange(W, device=dev).repeat(H)
        py = torch.arange(H, device=dev).repeat_interleave(W)
        with torch.no_grad():
            target = render_pixels(sa, cam, px, py, _NumpyDraws(1, dev), W,
                                   H, BruteForceIntersector(), recursions=2)
        start = merge_params(sa, {
            "mat_diffuse_rgb": torch.full_like(sa.mat_diffuse_rgb, 0.5),
            "tri_verts": sa.tri_verts + torch.from_numpy(
                (1e-3 * noise).astype(np.float32)).to(dev)})
        params = extract_params(start, ("mat_diffuse_rgb", "tri_verts"))
        opt = torch.optim.Adam(list(params.values()), lr=1e-2)
        step = make_train_step(opt, cam, px, py, W, H,
                               BruteForceIntersector(), target, recursions=2)
        params, loss = step(params, start, _NumpyDraws(2, dev))
        out[dev.type] = (float(loss), {k: v.grad.cpu().numpy()
                                       for k, v in params.items()})
    (lk, gk), (lc, gc) = out["cuda"], out["cpu"]
    assert lk == pytest.approx(lc, rel=1e-5) and lc > 0
    for k in gc:
        assert np.isfinite(gk[k]).all() and np.abs(gc[k]).max() > 0, k
        np.testing.assert_allclose(gk[k], gc[k], rtol=1e-3,
                                   atol=1e-5 * np.abs(gc[k]).max(),
                                   err_msg=k)


# -- multi-device rendering over NCCL at world size 1 ----------------------

class _SplitNumpyDraws(_NumpyDraws):
    def split(self, n):
        return [_SplitNumpyDraws(int(s), self.device)
                for s in self.rng.integers(0, 2 ** 62, size=n)]


def test_fused_wrapper_spans_nest_in_levels(card):
    """Under torch.profiler on the card, a fused render's wrapper spans
    (`rtx.bvh_spawn`, `rtx.bvh_shadow_shade`) lie inside its `rtx.level`
    spans, and each fused kernel starts after a span of its wrapper began:
    spans and device operations share one timeline."""
    from torch.profiler import ProfilerActivity, profile
    from raytracer_tpu_torch.inline_scene import create_inline_raytracer
    rt = create_inline_raytracer(width=64, height=64, device=card)
    assert rt.fused
    rt.render(8)                        # the kernels built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.render(8)
        torch.cuda.synchronize()
    host, dev = {}, {}
    for e in prof.events():
        where = (dev if e.device_type == torch.autograd.DeviceType.CUDA
                 else host)
        where.setdefault(e.name, []).append((e.time_range.start,
                                             e.time_range.end))
    levels = host["rtx.level"]
    assert len(levels) == 3
    for name, kernel in (("rtx.bvh_spawn", "spawn_kernel"),
                         ("rtx.bvh_shadow_shade", "shadow_shade_kernel")):
        spans = host[name]
        assert len(spans) == 3
        assert all(any(s <= a and b <= e for s, e in levels)
                   for a, b in spans), name
        starts = [a for k, ivs in dev.items() if kernel in k
                  and not k.startswith("rtx.") for a, _ in ivs]
        assert len(starts) == 3, (kernel, sorted(dev))
        assert all(any(s <= a for s, _ in spans) for a in starts)


@pytest.fixture(scope="module")
def nccl():
    """A one-rank NCCL process group on the card for the module's tests,
    destroyed after them."""
    import socket
    from raytracer_tpu_torch.parallel import initialize_distributed
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_distributed(
        backend="nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
        rank=0, timeout=60) is True
    yield torch.device("cuda")
    torch.distributed.destroy_process_group()


def test_nccl_bring_up_at_world_size_one(nccl):
    from raytracer_tpu_torch.parallel import initialize_distributed, make_mesh
    from raytracer_tpu_torch.parallel.mesh import (all_gather_rays,
                                                   all_reduce_sum)
    assert initialize_distributed() is True
    assert torch.distributed.get_backend() == "nccl"
    mesh = make_mesh()
    assert (mesh.size, mesh.rank) == (1, 0) and mesh.group is not None
    assert mesh.device.type == "cuda"
    x = torch.arange(12.0, device=nccl).view(4, 3)
    torch.testing.assert_close(all_gather_rays(mesh, x), x)
    torch.testing.assert_close(all_reduce_sum(mesh, x.clone()), x)


def test_render_sharded_on_the_card_matches_the_cpu(nccl):
    """render_sharded of ico3_tex (textured, tpl 70) at 64x64, spp 2,
    over the NCCL group on the card and with no group on the CPU, from the
    same numpy-made per-rank draws: at most 24 film values differ (the
    whole-render rule of chip_smoke.py), with 6 + 6 fused launches."""
    import pathlib
    import raytracer_tpu_torch as rtx
    from raytracer_tpu_torch.models.collada import ColladaLoader
    from raytracer_tpu_torch.parallel import Mesh
    scene = ColladaLoader.from_file(
        pathlib.Path(__file__).resolve().parent.parent / "data"
        / "ico3_tex.dae", width=64, height=64, verbose=False)
    films = {}
    for dev in ("cuda", "cpu"):
        rt = rtx.RayTracer(scene, 64, 64, device=dev,
                           draws=_SplitNumpyDraws(5, dev))
        mesh = None if dev == "cuda" else Mesh(1, 0, torch.device("cpu"))
        cuda_bvh.bvh_spawn.launches = 0
        films[dev] = rt.render_sharded(2, mesh=mesh)
        if dev == "cuda":
            assert cuda_bvh.bvh_spawn.launches == 3
    a, b = films["cuda"], films["cpu"]
    assert np.isfinite(a).all() and a.max() > 0
    assert (~np.isclose(a, b, rtol=2e-4, atol=2e-5)).sum() <= 24


def test_sharded_train_step_on_the_card_matches_unsharded(nccl):
    """The sharded train step over the NCCL group (4boxes 64x64, brute
    force, 2 bounces, Adam over the albedo from grey): the first step's
    loss, gradient and albedo equal diff.inverse's unsharded step from
    the same start and draws (rtol 1e-5: only the loss's reduction order
    differs), and the loss falls over 3 steps, with no kernel launch."""
    import dataclasses
    import pathlib
    from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
    from raytracer_tpu_torch.diff.inverse import (extract_params,
                                                  make_train_step)
    from raytracer_tpu_torch.models.collada import ColladaLoader
    from raytracer_tpu_torch.parallel import (make_mesh, make_sharded_render,
                                              make_sharded_train_step,
                                              pixel_grid)
    n = 64
    scene = ColladaLoader.from_file(
        pathlib.Path(__file__).resolve().parent.parent / "data"
        / "4boxes.dae", width=n, height=n, verbose=False)
    sa = scene.to_buffers().to_device(nccl)
    cam = scene.cameras[0].params(nccl)
    mesh = make_mesh()
    px, py, _ = pixel_grid(n, n)
    brute = BruteForceIntersector()
    with torch.no_grad():
        target = make_sharded_render(mesh, brute, n, n, recursions=2)(
            sa, cam, px, py, [_NumpyDraws(20, nccl)])
    start = dataclasses.replace(sa, mat_diffuse_rgb=torch.full_like(
        sa.mat_diffuse_rgb, 0.5))
    cuda_bvh.bvh_closest.launches = 0
    results = []
    for sharded in (True, False):
        params = extract_params(start, ("mat_diffuse_rgb",))
        opt = torch.optim.Adam(list(params.values()), lr=5e-2)
        if sharded:
            step = make_sharded_train_step(mesh, brute, n, n, opt,
                                           recursions=2)
            losses = [float(step(params, start, cam, px, py, target,
                                 [_NumpyDraws(21, nccl)])[0])]
        else:
            step = make_train_step(opt, cam, torch.from_numpy(px).to(nccl),
                                   torch.from_numpy(py).to(nccl), n, n,
                                   brute, target, recursions=2)
            losses = [float(step(params, start, _NumpyDraws(21, nccl))[1])]
        p = params["mat_diffuse_rgb"]
        results.append((losses[0], p.grad.cpu().numpy().copy(),
                        p.detach().cpu().numpy().copy()))
        if sharded:
            for _ in range(2):
                losses.append(float(step(params, start, cam, px, py, target,
                                         [_NumpyDraws(21, nccl)])[0]))
            assert losses[2] < losses[1] < losses[0], losses
    (ls, gs, ps), (lu, gu, pu) = results
    assert ls == pytest.approx(lu, rel=1e-5) and lu > 0
    np.testing.assert_allclose(gs, gu, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ps, pu, rtol=1e-5, atol=1e-7)
    assert cuda_bvh.bvh_closest.launches == 0
