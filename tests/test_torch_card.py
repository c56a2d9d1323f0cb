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


def _fused(card, tris, tpl=128, n_rec=6, seed=0):
    """A BVH intersector on the card with random shading records."""
    isect = BVHIntersector(_Buffers(tris), triangles_per_leaf=tpl,
                           device=card)
    rng = np.random.default_rng(seed)
    rec = rng.uniform(-1, 1, (isect.packed.num_slots, n_rec))
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
              children=b, emit_uv=planes.shape[0] == 7, key_mode="dir6")
    rows = torch.full((R,), -1, dtype=torch.int32, device=card)
    got = cuda_bvh.bvh_spawn(rays, g, lp, isect.packed, planes, rows_out=rows,
                             **kw)
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
    args = (got["shadow"], got["rec"][0:3], got["rec"][3:6], rays[3:6],
            lc.to(card))
    rows_sh = torch.full((L * R,), -1, dtype=torch.int32, device=card)
    rad = cuda_bvh.bvh_shadow_shade(*args, isect.packed, rows_out=rows_sh)
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


def test_fused_kernels_rays_needing_disjoint_rows(card):
    """Two clusters of triangles far apart, and one block whose rays
    alternate between them: the block's row list is the union of two
    disjoint sets, and each ray still gets its own closest hit."""
    rng = np.random.default_rng(7)
    n = 1500
    centers = np.zeros((2 * n, 1, 3))
    centers[:n, 0, 0], centers[n:, 0, 0] = -40.0, 40.0
    tris = (centers + rng.uniform(-3, 3, (2 * n, 1, 3))
            + rng.uniform(-0.7, 0.7, (2 * n, 3, 3))).astype(np.float32)
    R = 512
    side = np.where(np.arange(R) % 2 == 0, -40.0, 40.0)[:, None]
    o = np.concatenate([side[:, :1], np.zeros((R, 1)), np.full((R, 1), -20.0)],
                       axis=1) + rng.uniform(-2, 2, (R, 3))
    d = np.concatenate([rng.uniform(-0.05, 0.05, (R, 2)), np.ones((R, 1))],
                       axis=1)
    isect = _fused(card, tris)
    got, rows, _ = _fused_check(card, isect, torch.from_numpy(o.astype(
        np.float32)), torch.from_numpy(d.astype(np.float32)), b=0)
    hit = got["t"] < np.float32(BIG_T)
    assert bool(hit[0::2].any()) and bool(hit[1::2].any())
    # the rows a ray of each cluster needs lie in its own half of the BVH
    need = torch.zeros((R,), dtype=torch.int32, device=card)
    cuda_bvh.bvh_closest(rays_from(torch.from_numpy(o.astype(np.float32)),
                                   torch.from_numpy(d.astype(np.float32))
                                   ).to(card), isect.packed, rows_out=need)
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
    """bvh_closest's lanes_out counts, within the rows the per-ray walk
    tests (rows_out), the lanes of the segments a ray enters before its
    best t: a row of one segment counts whole; else each tested row
    counts between one segment and all of its lanes, whole segments, and
    some segments are skipped.  Counting changes no output."""
    tris, o, d = _random()
    isect = BVHIntersector(_Buffers(tris), seg=seg, device=card)
    C, S = isect.packed.C, isect.packed.S
    assert S == seg
    rays = rays_from(o, d).to(card)
    for kw in (dict(), dict(t_limit=1.0, shadow=True)):
        rows = torch.full((rays.shape[1],), -1, dtype=torch.int32,
                          device=card)
        lanes = torch.full_like(rows, -1)
        got = cuda_bvh.bvh_closest(rays, isect.packed, rows_out=rows,
                                   lanes_out=lanes, **kw)
        want = cuda_bvh.bvh_closest(rays, isect.packed, **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        dead = (rays[0].abs() >= 1e30)
        assert int(rows[dead].sum()) == 0 and int(lanes[dead].sum()) == 0
        if S == 1:
            assert torch.equal(lanes, rows * C)
        else:
            assert bool((lanes % (C // S) == 0).all())
            assert bool((lanes >= rows * (C // S)).all())
            assert bool((lanes <= rows * C).all())
            assert int(lanes.sum()) < int(rows.sum()) * C
