"""The port's copy of the compat octree (raytracer_tpu_torch/compat) on
the cases of tests/test_octree_compat.py, with the port's loader and
camera, and against the JAX package's octree on the same rays, hit for
hit (both are numpy; the answers must be identical)."""

import numpy as np
import pytest

from raytracer_tpu.compat.octree import OctTreeIntersector as RefOctTree
from raytracer_tpu_torch.compat.octree import (OctTreeIntersector,
                                               _intersect_cube_inverse_ray,
                                               mt_intersect_scalar)
from raytracer_tpu_torch.models.collada import ColladaLoader
from tests import oracle

LO, HI = np.array([-1., -1, -1]), np.array([1., 1, 1])


# slab tests mirroring oct_tree_intersector.rs:471-513
def test_slab_hit_from_outside():
    o = np.array([2.0, 0.0, 0.0], np.float32)
    inv = 1.0 / np.array([-1.0, 0.1, 0.1], np.float32)
    assert _intersect_cube_inverse_ray(o, inv, LO, HI) == pytest.approx(1.0)


def test_slab_axis_parallel_inf_handled():
    with np.errstate(divide="ignore"):
        inv = 1.0 / np.array([-1.0, 0.0, 0.0], np.float32)
    o = np.array([2.0, 0.0, 0.0], np.float32)
    assert _intersect_cube_inverse_ray(o, inv, LO, HI) == pytest.approx(1.0)


def test_slab_origin_inside_negative_t():
    o = np.array([-0.9, 0.0, 0.0], np.float32)
    inv = 1.0 / np.array([1.0, 0.1, 0.1], np.float32)
    assert _intersect_cube_inverse_ray(o, inv, LO, HI) < 0.0


def test_slab_miss_is_none():
    o = np.array([-2.0, 0.0, 0.0], np.float32)
    inv = 1.0 / np.array([-1.0, 0.1, 0.1], np.float32)
    assert _intersect_cube_inverse_ray(o, inv, LO, HI) is None


@pytest.fixture(scope="module")
def boxes(data_dir):
    scene = ColladaLoader.from_file(data_dir / "4boxes.dae", width=16,
                                    height=12, verbose=False)
    return scene, scene.to_buffers()


def _rays(scene):
    cam = scene.cameras[0]
    return [cam.get_ray(x, y, (0.5, 0.5)) for y in range(12)
            for x in range(16)]


def test_octree_matches_brute_on_4boxes(boxes):
    scene, buf = boxes
    tree = OctTreeIntersector(buf.tri_verts, triangles_per_leaf=10)
    agree = 0
    rays = _rays(scene)
    for o, d in rays:
        tree_hit = tree.intersect_ray(o, d)
        brute_hit = oracle.closest_hit(o, d, buf.tri_verts)
        if (tree_hit is None) == (brute_hit is None):
            if tree_hit is None or tree_hit[3] == brute_hit[3]:
                agree += 1
    # the hit-in-cube quirk misses some rays grazing leaf boundaries
    # (oct_tree_intersector.rs:160-169); it must agree elsewhere
    assert agree / len(rays) > 0.95
    assert agree < len(rays), "expected the boundary quirk to show up"


def test_octree_matches_reference_octree_hit_for_hit(boxes):
    """The same tree, and the same answer for every ray of the frame and
    for random rays aimed into the scene from around it."""
    scene, buf = boxes
    tree = OctTreeIntersector(buf.tri_verts, triangles_per_leaf=10)
    ref = RefOctTree(buf.tri_verts, triangles_per_leaf=10)
    assert len(tree.nodes) == len(ref.nodes)
    for a, b in zip(tree.cubes, ref.cubes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tv = buf.tri_verts.reshape(-1, 3)
    lo, hi = tv.min(axis=0), tv.max(axis=0)
    rng = np.random.default_rng(8)
    rays = _rays(scene)
    for _ in range(200):
        o = (lo + hi) / 2 + 2 * (hi - lo) * rng.normal(size=3)
        rays.append((o.astype(np.float32),
                     (rng.uniform(lo, hi) - o).astype(np.float32)))
    hits = 0
    for o, d in rays:
        a, b = tree.intersect_ray(o, d), ref.intersect_ray(o, d)
        assert (a is None) == (b is None)
        if a is not None:
            hits += 1
            assert tuple(a) == tuple(b)
    assert hits > 100


def test_octree_splits_on_small_leaf(data_dir):
    scene = ColladaLoader.from_file(data_dir / "4boxes.dae", width=8,
                                    height=8, verbose=False)
    buf = scene.to_buffers()
    tree = OctTreeIntersector(buf.tri_verts, triangles_per_leaf=10)
    assert len(tree.nodes) > 1  # 48 tris with leaf<=10 must split
    assert len(tree.nodes) == len(tree.cubes)  # parallel-array invariant
    leaf_sizes = [len(n.tri_indices) for n in tree.nodes
                  if n.tri_indices is not None]
    assert max(leaf_sizes) <= 48


def test_scalar_mt_agrees_with_oracle():
    rng = np.random.default_rng(5)
    for _ in range(50):
        tri = rng.uniform(-1, 1, size=(3, 3)).astype(np.float32)
        o = rng.uniform(-2, 2, size=3).astype(np.float32)
        d = rng.normal(size=3).astype(np.float32)
        a = mt_intersect_scalar(o, d, tri[0], tri[1], tri[2])
        b = oracle.mt_intersect(o, d, tri[0], tri[1], tri[2])
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == pytest.approx(b[0], rel=1e-5)
