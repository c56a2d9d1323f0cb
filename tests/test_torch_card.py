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
