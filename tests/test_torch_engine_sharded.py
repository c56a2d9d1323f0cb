"""`RayTracer.render_sharded` of the port (tests/test_engine_sharded.py on
the port): at one rank with no process group it equals the replay of its
rank's draws through the port's own wavefront, and the JAX engine's
render_sharded on a one-device mesh with the same keys; the film adds up
over calls; over the fused BVH path with two samples pooled it equals
the replay one sample at a time, bit for bit.  The multi-rank gather
runs in tests/test_torch_distributed.py (two gloo processes)."""

import numpy as np
import pytest
import torch

from raytracer_tpu import create_raytracer_from_file as jax_create
from raytracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
import raytracer_tpu_torch as rtx
from raytracer_tpu_torch.core.wavefront import (trace_radiance,
                                                trace_radiance_fused)
from raytracer_tpu_torch.models.camera import generate_rays
from raytracer_tpu_torch.parallel import pixel_grid
from tests.test_torch_wavefront import ThreefryDraws
from tests.test_torch_wavefront import torch_threads  # noqa: F401 (autouse)

W, H = 32, 16
SPP = 2
SEED = 11


def _port(data_dir, **kw):
    return rtx.create_raytracer_from_file(str(data_dir / "4boxes.dae"),
                                          width=W, height=H, device="cpu",
                                          **kw)


def _replay(rt, draws, spp, fused):
    """The rank's samples one at a time through the port's wavefront."""
    px, py, real = pixel_grid(W, H)
    px, py = torch.from_numpy(px), torch.from_numpy(py)
    cam = rt.camera.params("cpu")
    psum = torch.zeros((len(px), 3))
    psq = torch.zeros_like(psum)
    for _ in range(spp):
        jitter, stream = draws.next_sample(len(px))
        o, d = generate_rays(cam, px, py, jitter, W, H)
        trace = trace_radiance_fused if fused else trace_radiance
        rad = trace(rt.scene_arrays, o, d, [stream], rt.intersector,
                    rt.recursions, rt.spread)
        psum += rad
        psq += rad * rad
    return psum[:real].numpy(), psq[:real].numpy()


@pytest.mark.parametrize("recursions", [0, 1])
def test_render_sharded_matches_replay_and_reference(data_dir, recursions):
    """One rank, brute force: the film equals the replay of
    `draws.split(1)[0]` exactly, and the JAX engine's render_sharded on
    a one-device mesh with the same keys (rtol 1e-5 with no bounce; the
    flip rule of tests/test_engine_sharded.py:88-93 with one)."""
    rt = _port(data_dir, accel="brute", recursions=recursions,
               draws=ThreefryDraws(SEED, recursions))
    hdr = rt.render_sharded(spp=SPP)
    assert hdr.shape == (H, W, 3) and np.isfinite(hdr).all()
    assert rt.film.num_samples.eq(SPP).all()
    psum, psq = _replay(rt, ThreefryDraws(SEED, recursions).split(1)[0], SPP,
                        fused=False)
    np.testing.assert_array_equal(rt.film.pixel_sum.numpy(), psum)
    np.testing.assert_array_equal(rt.film.pixel_sum_sq.numpy(), psq)

    jrt = jax_create(str(data_dir / "4boxes.dae"), width=W, height=H,
                     accel="brute", recursions=recursions, seed=SEED)
    want = jrt.render_sharded(spp=SPP, mesh=jax_make_mesh(1))
    if recursions == 0:
        np.testing.assert_allclose(hdr, want, rtol=1e-5, atol=1e-6)
    else:
        got, want = rt.film.pixel_sum.numpy(), np.asarray(jrt.film.pixel_sum)
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert (~close).sum() <= 24, f"{(~close).sum()} of {close.size}"
        assert abs(got.mean() - want.mean()) < 0.02 * abs(want.mean())


def test_render_sharded_accumulates_additively(data_dir):
    rt = _port(data_dir, accel="brute", recursions=0, seed=3)
    rt.render_sharded(spp=1)
    s1 = rt.film.pixel_sum.clone()
    rt.render_sharded(spp=2)
    assert rt.film.num_samples.eq(3).all()
    # the second call adds on top of the first, from new draws
    s3 = rt.film.pixel_sum
    assert torch.isfinite(s3).all() and (s3 >= s1 - 1e-6).all()
    assert not torch.allclose(s3, 3 * s1)


def test_render_sharded_fused_pool_matches_replay(data_dir):
    """The fused BVH path with 2 samples pooled per wavefront, default
    draws, one bounce: the film equals the replay of the rank's samples
    one wavefront each through trace_radiance_fused, bit for bit."""
    rt = _port(data_dir, recursions=1, seed=SEED, spp_pool=2)
    assert rt.fused and rt._choose_pool(SPP) == 2
    rt.render_sharded(spp=SPP)
    psum, psq = _replay(rt, rtx.TorchDraws(SEED, "cpu").split(1)[0], SPP,
                        fused=True)
    assert psum.max() > 0
    np.testing.assert_array_equal(rt.film.pixel_sum.numpy(), psum)
    np.testing.assert_array_equal(rt.film.pixel_sum_sq.numpy(), psq)
