"""The port's RayTracer (core/engine.py) against the JAX package's
engine: the same scene and the same threefry key chain (replayed
through the adapter of tests/test_torch_wavefront.py) through both
engines, plus the progressive-film API, the device rule and the import
boundary of the port."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu import create_raytracer_from_file as jax_create
from raytracer_tpu_torch import RayTracer, create_raytracer_from_file
from raytracer_tpu_torch.core.tonemap import pack_u32, simple_map
from raytracer_tpu_torch.models.collada import ColladaLoader
from tests.test_torch_wavefront import ThreefryDraws

W, H = 32, 16


def _port(data_dir, seed=3, recursions=2, **kw):
    return create_raytracer_from_file(
        str(data_dir / "4boxes.dae"), width=W, height=H, device="cpu",
        recursions=recursions, draws=ThreefryDraws(seed, recursions), **kw)


def _assert_flip_bound(got, want):
    """The repo's rule (tests/test_fused_spawn.py:56-62): bound the COUNT
    of edge-flipped values.  Primary rays may differ by an ulp between
    the engines' ray generation, and one flipped bounce changes its
    pixel's sample outright, so on a 512-pixel image the channel means
    are no tighter test than the count."""
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert (~close).sum() <= 24, f"{(~close).sum()} of {close.size} mismatch"


def test_render_matches_reference_engine(data_dir):
    """render(spp=2): the port pools both samples into one wavefront;
    the JAX engine on the CPU renders them one by one on its unfused
    path, whose semantics the fused path equals."""
    want = jax_create(str(data_dir / "4boxes.dae"), width=W, height=H,
                      seed=3).render(spp=2)
    rt = _port(data_dir)
    assert rt._choose_pool(2) == 2
    got = rt.render(spp=2)
    assert got.shape == want.shape == (H, W, 3)
    assert np.isfinite(got).all() and got.max() > 0
    _assert_flip_bound(got, want)
    assert rt.film.num_samples.eq(2.0).all()


def test_trace_frame_additive_matches_reference(data_dir):
    jrt = jax_create(str(data_dir / "4boxes.dae"), width=W, height=H,
                     seed=4, rows_per_frame=10, accel="brute")
    rt = _port(data_dir, seed=4, rows_per_frame=10)
    for _ in range(2):
        assert rt.trace_frame_additive() == jrt.trace_frame_additive() == 10 * W
    want = np.asarray(jrt.film.get_pixels()).reshape(H, W, 3)
    got = rt.film.get_pixels().numpy().reshape(H, W, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    rows = ~np.isnan(want[:, 0, 0])
    _assert_flip_bound(got[rows], want[rows])
    differ = rt.get_tonemapped_pixels() != jrt.get_tonemapped_pixels()
    assert differ.sum() <= 24, f"{differ.sum()} packed pixels differ"


def test_trace_frame_additive_progression(data_dir):
    rt = _port(data_dir, rows_per_frame=10, recursions=0)
    n = rt.trace_frame_additive()
    assert n == 10 * W  # num_primary_rays = rows * width (mod.rs:113-116)
    assert rt.current_row == 10
    samples = rt.film.num_samples.numpy().reshape(H, W)
    assert (samples[:10] == 1).all() and (samples[10:] == 0).all()
    rt.trace_frame_additive()       # cursor wraps (mod.rs:114)
    assert rt.current_row == 20 % H
    samples = rt.film.num_samples.numpy().reshape(H, W)
    assert (samples[:4] == 2).all() and (samples[4:] == 1).all()


def test_tonemapped_pixels_white_for_unsampled(data_dir):
    rt = _port(data_dir, rows_per_frame=4, recursions=0)
    rt.trace_frame_additive()
    pix = rt.get_tonemapped_pixels()
    assert pix.dtype == np.uint32 and pix.shape == (H * W,)
    # unsampled rows pack as opaque white (Rust NaN min/max chain parity)
    assert (pix[-W:] == 0xFFFFFFFF).all()
    assert (pix[:4 * W] >> 24 == 0xFF).all()
    img = rt.get_tonemapped_image()
    assert img.dtype == np.uint8 and (img[4:] == 255).all()


def test_camera_motion_clears_film(data_dir):
    rt = _port(data_dir, rows_per_frame=4, recursions=0)
    rt.trace_frame_additive()
    assert float(rt.film.num_samples.sum()) > 0
    rt.move_camera(0.1, 0.0, 0.0)
    assert float(rt.film.num_samples.sum()) == 0.0
    rt.trace_frame_additive()
    rt.rotate_camera(0.05, 0.0)
    assert float(rt.film.pixel_sum.abs().sum()) == 0.0


def test_pack_u32_layout():
    assert int(pack_u32(torch.tensor([[1.0, 0.0, 0.0]]))[0]) == 0xFFFF0000
    assert int(pack_u32(torch.tensor([[0.0, 1.0, 0.0]]))[0]) == 0xFF00FF00
    assert int(pack_u32(torch.tensor([[0.0, 0.0, 1.0]]))[0]) == 0xFF0000FF
    nan = torch.full((1, 3), float("nan"))
    assert int(pack_u32(nan)[0]) == 0xFFFFFFFF
    np.testing.assert_allclose(
        simple_map(torch.tensor([0.0, 1.0, 3.0])).numpy(), [0.0, 0.5, 0.75])


def test_default_device_without_a_card_raises(data_dir, monkeypatch):
    """Entry points run on CUDA unless asked for the CPU; without a
    card they raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = ColladaLoader.from_file(data_dir / "4boxes.dae", width=W,
                                    height=H, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RayTracer(scene, W, H)
    with pytest.raises(ValueError):
        RayTracer(scene, W, H, device="cpu", sort_key_mode="octant")
    with pytest.raises(ValueError, match="octree"):
        RayTracer(scene, W, H, device="cpu", accel="octree")


def test_import_loads_neither_jax_nor_reference_package():
    """Every module of the port, imported in a fresh process, loads
    neither JAX nor the reference package."""
    code = ("import importlib, pkgutil, sys, raytracer_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'raytracer_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'raytracer_tpu' or "
            "m.startswith('raytracer_tpu.')]; print(' '.join(names)); "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    names, bad = out.stdout.strip().splitlines()
    assert bad == "[]", out.stdout
    names = set(names.split())
    for mod in ("native", "core.intersect", "core.intersectors",
                "core.sampler", "core.shade", "core.wavefront", "core.engine",
                "core.film", "core.tonemap", "ops.cluster", "ops.cuda_build",
                "ops.cuda_bvh", "ops.cuda_cluster", "cli", "viewer",
                "inline_scene", "diff.gradients", "diff.inverse",
                "diff.checkpoint", "utils.stats", "utils.timing",
                "utils.png_io", "utils.profiling", "parallel",
                "parallel.mesh", "parallel.render", "parallel.dryrun",
                "compat", "compat.octree"):
        assert f"raytracer_tpu_torch.{mod}" in names, mod


@pytest.mark.parametrize("accel", ["cluster", "brute"])
def test_render_matches_reference_engine_unfused(data_dir, accel):
    """accel="cluster"/"brute": the composable wavefront, one sample per
    wavefront, in both engines (engine.py:135-155, :326-338)."""
    want = jax_create(str(data_dir / "4boxes.dae"), width=W, height=H,
                      seed=3, accel=accel).render(spp=2)
    rt = _port(data_dir, accel=accel)
    assert not rt.fused and rt._choose_pool(2) == 1
    got = rt.render(spp=2)
    assert np.isfinite(got).all() and got.max() > 0
    _assert_flip_bound(got, want)
    assert rt.film.num_samples.eq(2.0).all()


@pytest.mark.parametrize("accel", ["cluster", "brute"])
def test_trace_frame_additive_matches_reference_unfused(data_dir, accel):
    jrt = jax_create(str(data_dir / "4boxes.dae"), width=W, height=H,
                     seed=4, rows_per_frame=10, accel=accel)
    rt = _port(data_dir, seed=4, rows_per_frame=10, accel=accel)
    for _ in range(2):
        assert rt.trace_frame_additive() == jrt.trace_frame_additive()
    want = np.asarray(jrt.film.get_pixels()).reshape(H, W, 3)
    got = rt.film.get_pixels().numpy().reshape(H, W, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    rows = ~np.isnan(want[:, 0, 0])
    _assert_flip_bound(got[rows], want[rows])


def test_brute_and_cluster_render_identically(data_dir):
    """tests/test_engine.py:54-63 on the port: the same draws through the
    oracle and the cluster grid."""
    a = _port(data_dir, accel="brute").render(spp=1)
    b = _port(data_dir, accel="cluster").render(spp=1)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_pool_budget_and_intersector_argument(data_dir):
    """Only the fused path pools samples: off it the auto budget is 1
    and an explicit budget above 1 raises.  A ready intersector (BVH,
    no records) is taken as given and gets the records installed."""
    from raytracer_tpu_torch import make_intersector
    rt = _port(data_dir, accel="cluster")
    assert rt._choose_pool(16) == 1
    rt = _port(data_dir, accel="cluster", spp_pool=4)
    with pytest.raises(ValueError, match="fused"):
        rt.render(spp=4)
    scene = ColladaLoader.from_file(data_dir / "4boxes.dae", width=W,
                                    height=H, verbose=False)
    isect = make_intersector("bvh", scene.to_buffers(), device="cpu")
    assert not isect.supports_fused_spawn
    rt = RayTracer(scene, W, H, intersector=isect, device="cpu")
    assert rt.intersector is isect and rt.fused
    assert rt._choose_pool(16) == 8
