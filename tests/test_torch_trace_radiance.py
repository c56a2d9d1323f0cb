"""The port's composable wavefront (core/wavefront.py trace_radiance)
against the JAX package's trace_radiance on the same scene, the same
primary rays and the same threefry draws, over all three intersectors:
brute force, the cluster grid and the BVH (no records, slot records,
and records extracted in the kernel), bounce sort on and off.  The JAX
cluster and BVH intersectors run their XLA closest hit on the CPU, the
same function as their Pallas kernels (tests/test_pallas_bvh.py,
tests/test_intersect.py); the port's run the kernels' plain versions.

Tolerance: the repo's flip rule (tests/test_fused_spawn.py:56-62), at
most 24 values beyond rtol 2e-4 / atol 2e-5: the reference's XLA build
may contract a*b+c, so a ray on a triangle edge may flip and change its
pixel's sample outright.  Inside the port, the fused wavefront and the
composable one compute the same radiance bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import create_raytracer_from_file as jax_create
from raytracer_tpu.core.intersectors import BruteForceIntersector as JaxBrute
from raytracer_tpu.core.shade import build_slot_records as jax_slot_records
from raytracer_tpu.core.wavefront import trace_radiance as jax_trace
from raytracer_tpu.models.camera import generate_rays as jax_generate_rays
from raytracer_tpu.ops.pallas_bvh import BVHIntersector as JaxBVH
from raytracer_tpu.ops.pallas_intersect import ClusterIntersector as JaxCluster
from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
from raytracer_tpu_torch.core.shade import build_slot_records
from raytracer_tpu_torch.core.wavefront import (trace_radiance,
                                                trace_radiance_fused)
from raytracer_tpu_torch.models.camera import generate_rays
from raytracer_tpu_torch.models.collada import ColladaLoader
from raytracer_tpu_torch.models.types import SceneArrays
from raytracer_tpu_torch.ops.cuda_bvh import BVHIntersector
from raytracer_tpu_torch.ops.cuda_cluster import ClusterIntersector
from tests.test_torch_wavefront import ThreefryStream


def _assert_flip_bound(got, want):
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert (~close).sum() <= 24, f"{(~close).sum()} of {close.size} mismatch"


def _setup(data_dir, scene, W, H):
    rt = jax_create(str(data_dir / scene), width=W, height=H, accel="brute")
    sb = rt.scene_buffers
    key = jax.random.PRNGKey(11)
    kj, kt = jax.random.split(key)
    px = jnp.asarray(np.tile(np.arange(W, dtype=np.int32), H))
    py = jnp.asarray(np.repeat(np.arange(H, dtype=np.int32), W))
    jitter = jax.random.uniform(kj, (W * H, 2), dtype=jnp.float32)
    o, d = jax_generate_rays(rt.camera.params(), px, py, jitter, W, H)
    has_tex = bool((sb.mat_tex_id >= 0).any())

    jc = JaxCluster(sb, triangles_per_leaf=70, use_pallas=False)
    g = jc.grid
    pc = ClusterIntersector.from_grid_arrays(
        g.perm, g.v0, g.e1, g.e2, g.aabb_min, g.aabb_max, g.orders,
        device="cpu")
    jb = JaxBVH(sb, triangles_per_leaf=128, use_pallas=False)
    b = jb.bvh
    pb = BVHIntersector.from_bvh_arrays(
        b.perm, b.v0, b.e1, b.e2, b.leaf_aabb, b.seg_aabb, b.sc_aabb,
        b.orders, group=8, device="cpu")
    pscene = SceneArrays.from_numpy(sb, device="cpu")
    records = {}
    for name, j, p in (("cluster", jc, pc), ("bvh", jb, pb)):
        records[name] = (
            jax_slot_records(rt.scene_arrays, j.perm, j.perm.shape[0]),
            build_slot_records(pscene, p.perm, p.perm.shape[0]))
    pb_fused = BVHIntersector.from_bvh_arrays(
        b.perm, b.v0, b.e1, b.e2, b.leaf_aabb, b.seg_aabb, b.sc_aabb,
        b.orders, group=8, device="cpu")
    pb_fused.set_shade_records(records["bvh"][1][:, :7 if has_tex else 6])
    return dict(jscene=rt.scene_arrays, pscene=pscene, o=o, d=d, kt=kt,
                has_tex=has_tex, records=records,
                isect={"brute": (JaxBrute(), BruteForceIntersector()),
                       "cluster": (jc, pc), "bvh": (jb, pb),
                       "bvh_fused": (jb, pb_fused)})


@pytest.fixture(scope="module")
def scenes(data_dir):
    return {"4boxes": _setup(data_dir, "4boxes.dae", 24, 16),
            "ico3_tex": _setup(data_dir, "ico3_tex.dae", 16, 16)}


def _port(s, accel, mode, sort, recursions=2):
    _, isect = s["isect"][accel]
    o = torch.from_numpy(np.array(s["o"]))
    d = torch.from_numpy(np.array(s["d"]))
    kw = {}
    if mode == "records":
        kw = dict(shade_records=s["records"][accel][1],
                  has_textures=s["has_tex"])
    elif mode == "fused":
        kw = dict(fused_shade=True, has_textures=s["has_tex"])
    return trace_radiance(
        s["pscene"], o, d, [ThreefryStream(s["kt"], recursions)],
        isect, recursions=recursions, spread=1, sort_rays=sort,
        **kw).numpy()


def _reference(s, accel, mode, sort, recursions=2):
    """The JAX trace_radiance; the in-kernel record path ("fused") is
    the slot-record path there (prepare_shade_fused and
    prepare_shade_fast compute the same context)."""
    isect, _ = s["isect"][accel]
    kw = {}
    if mode in ("records", "fused"):
        kw = dict(shade_records=s["records"][accel.split("_")[0]][0],
                  has_textures=s["has_tex"])
    return np.asarray(jax_trace(s["jscene"], s["o"], s["d"], s["kt"], isect,
                                recursions=recursions, spread=1,
                                sort_rays=sort, **kw))


CASES = ([("brute", "none", True)]
         + [(a, m, sort) for a, m in (("cluster", "none"),
                                       ("cluster", "records"),
                                       ("bvh", "none"), ("bvh", "records"),
                                       ("bvh_fused", "fused"))
            for sort in (True, False)])


@pytest.mark.parametrize("scene", ["4boxes", "ico3_tex"])
@pytest.mark.parametrize("accel,mode,sort", CASES)
def test_trace_radiance_matches_reference(scenes, scene, accel, mode, sort):
    s = scenes[scene]
    want = _reference(s, accel, mode, sort)
    got = _port(s, accel, mode, sort)
    assert got.shape == want.shape and want.max() > 0
    _assert_flip_bound(got, want)


@pytest.mark.parametrize("accel", ["brute", "cluster", "bvh"])
def test_direct_lighting_matches_reference_tightly(scenes, accel):
    """recursions=0: no Monte-Carlo children, no draws."""
    s = scenes["4boxes"]
    want = _reference(s, accel, "none", True, recursions=0)
    got = _port(s, accel, "none", True, recursions=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scene", ["4boxes", "ico3_tex"])
def test_composable_equals_fused_bit_for_bit(scenes, scene):
    """The fused wavefront (spawn + shadow-shade levels) and the
    composable one over the same BVH with in-kernel records, the same
    draws and the same sort compute the same radiance exactly, as the
    reference's two paths do (tests/test_fused_spawn.py)."""
    s = scenes[scene]
    _, isect = s["isect"]["bvh_fused"]
    want = trace_radiance_fused(
        s["pscene"], torch.from_numpy(np.array(s["o"])),
        torch.from_numpy(np.array(s["d"])), [ThreefryStream(s["kt"], 2)],
        isect, recursions=2, spread=1).numpy()
    got = _port(s, "bvh_fused", "fused", True)
    np.testing.assert_array_equal(got, want)
    # and the slot-record path is the same function
    np.testing.assert_array_equal(_port(s, "bvh", "records", True), got)


def test_sort_only_reorders(scenes):
    """Sorted and unsorted bounce levels give the same bits: draws ride
    the sort and the radiance is unsorted by each ray's original index."""
    s = scenes["4boxes"]
    for accel in ("cluster", "bvh"):
        np.testing.assert_array_equal(_port(s, accel, "none", True),
                                      _port(s, accel, "none", False))


@pytest.mark.parametrize("name", ["4boxes", "ico2"])
def test_brute_direct_render_matches_golden(data_dir, name):
    """tests/test_golden.py's rule on the port: brute force, recursions 0,
    jitter 0.5, against the committed reference images."""
    W, H = 64, 48
    golden = np.load(data_dir.parent / "tests" / "golden"
                     / f"{name}_{W}x{H}_direct.npy")
    scene = ColladaLoader.from_file(data_dir / f"{name}.dae", width=W,
                                    height=H, verbose=False)
    arrays = scene.to_buffers().to_device("cpu")
    px = torch.from_numpy(np.tile(np.arange(W, dtype=np.int32), H))
    py = torch.from_numpy(np.repeat(np.arange(H, dtype=np.int32), W))
    jit = torch.full((W * H, 2), 0.5)
    o, d = generate_rays(scene.cameras[0].params("cpu"), px, py, jit, W, H)
    rad = trace_radiance(arrays, o, d, [None], BruteForceIntersector(),
                         recursions=0)
    img = rad.numpy().reshape(H, W, 3)
    close = np.isclose(img, golden, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"golden mismatch on {(~close).sum()} pixels"


def test_direct_lighting_matches_oracle(data_dir):
    """tests/test_engine.py::test_direct_lighting_matches_oracle on the
    port: brute force, recursions 0, jitter 0.5 at 32x24 against the
    independent scalar per-pixel oracle (tests/oracle.py::render_direct);
    at most 2 % of the pixels may differ beyond 1e-2 of their scale (f32
    associativity at geometric edges), as there."""
    from tests import oracle
    W, H = 32, 24
    scene = ColladaLoader.from_file(data_dir / "4boxes.dae", width=W,
                                    height=H, verbose=False)
    buf = scene.to_buffers()
    px = torch.from_numpy(np.tile(np.arange(W, dtype=np.int32), H))
    py = torch.from_numpy(np.repeat(np.arange(H, dtype=np.int32), W))
    jit = torch.full((W * H, 2), 0.5)
    o, d = generate_rays(scene.cameras[0].params("cpu"), px, py, jit, W, H)
    rad = trace_radiance(buf.to_device("cpu"), o, d, [None],
                         BruteForceIntersector(), recursions=0)
    img = rad.numpy().reshape(H, W, 3)
    expect = oracle.render_direct(buf, scene.cameras[0], W, H,
                                  jitter=(0.5, 0.5))
    diff = np.abs(img - expect).max(axis=-1)
    agree = (diff < 1e-2 * (1.0 + np.abs(expect).max(axis=-1))).mean()
    assert agree > 0.98, f"only {agree:.3f} of pixels agree"
    assert img.max() > 0.0
