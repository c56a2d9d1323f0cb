"""The port's multi-device layer (raytracer_tpu_torch/parallel) against
the JAX package's on its 8-device virtual CPU mesh
(tests/test_parallel.py): the pixel grid, each rank's shard of the
sharded render and frame loop replayed in this process through a
one-rank view of an 8-rank mesh (no process group), the bring-up's
outcomes, and the sharded train step at one rank.

Draws: `ThreefryDraws.split(8)` replays the reference's per-device keys,
so both sides trace the same rays with the same Gaussians.  Tolerance:
rtol 1e-5 / atol 1e-6 with no bounce (tests/test_parallel.py:60); with
one bounce the flip rule of tests/test_engine_sharded.py:88-93 (at most
24 values beyond rtol 1e-4 / atol 1e-5, the mean within 2 %)."""

import dataclasses
import socket

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from raytracer_tpu.core.intersectors import BruteForceIntersector as JaxBrute
from raytracer_tpu.models.collada import ColladaLoader as JaxLoader
from raytracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytracer_tpu.parallel import render as jax_render
from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
from raytracer_tpu_torch.diff.inverse import extract_params
from raytracer_tpu_torch.models.collada import ColladaLoader
from raytracer_tpu_torch.parallel import (Mesh, initialize_distributed,
                                          make_mesh, make_sharded_frame_loop,
                                          make_sharded_render,
                                          make_sharded_train_step, pixel_grid,
                                          ray_sharding, replicated)
from raytracer_tpu_torch.parallel.mesh import all_gather_rays
from tests.test_torch_wavefront import ThreefryDraws

W, H = 32, 16
N = 8


@pytest.fixture(scope="module")
def scenes(data_dir):
    js = JaxLoader.from_file(data_dir / "4boxes.dae", width=W, height=H,
                             verbose=False)
    ps = ColladaLoader.from_file(data_dir / "4boxes.dae", width=W, height=H,
                                 verbose=False)
    return dict(jdev=js.to_buffers().to_device(), jcam=js.cameras[0].params(),
                pdev=ps.to_buffers().to_device("cpu"),
                pcam=ps.cameras[0].params("cpu"))


def _views():
    return [Mesh(N, r, torch.device("cpu")) for r in range(N)]


def _first_sample_keys(rank_draws):
    """The key each rank's first sample draws from (its `k` of
    key, k = split(key)): make_sharded_render and the train step take
    it as the device key (render.py:50-51, :173-174)."""
    return jnp.stack([jax.random.split(d.key)[1] for d in rank_draws])


def _assert_flip_rule(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert (~close).sum() <= 24, f"{(~close).sum()} of {close.size} mismatch"
    assert abs(got.mean() - want.mean()) < 0.02 * abs(want.mean())


@pytest.mark.parametrize("w,h,pad", [(32, 16, 8), (5, 3, 4), (7, 7, 1),
                                     (1024, 3, 6)])
def test_pixel_grid_matches_reference(w, h, pad):
    got = pixel_grid(w, h, pad_to=pad)
    want = jax_render.pixel_grid(w, h, pad_to=pad)
    assert got[2] == want[2] == w * h
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) % pad == 0


@pytest.mark.parametrize("recursions", [0, 1])
def test_rank_shards_match_reference_sharded_render(scenes, recursions):
    """Rank r of 8, replayed alone, traces exactly the JAX
    make_sharded_render's shard r."""
    mesh = jax_make_mesh()
    assert mesh.devices.size == N
    px, py, _ = pixel_grid(W, H, pad_to=N)
    ranks = ThreefryDraws(0, recursions).split(N)
    want = np.asarray(jax_render.make_sharded_render(
        mesh, JaxBrute(), W, H, recursions=recursions)(
            scenes["jdev"], scenes["jcam"], jnp.asarray(px), jnp.asarray(py),
            _first_sample_keys(ranks)))
    got = []
    for view in _views():
        render = make_sharded_render(view, BruteForceIntersector(), W, H,
                                     recursions=recursions)
        rad = render(scenes["pdev"], scenes["pcam"], px, py, ranks)
        assert rad.shape == (len(px) // N, 3)
        got.append(rad.numpy())
    got = np.concatenate(got)
    assert np.isfinite(got).all() and got.max() > 0
    if recursions == 0:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        _assert_flip_rule(got, want)


def test_rank_frame_loops_match_reference(scenes):
    """make_sharded_frame_loop, 2 spp, no bounce: each rank's moments
    equal the JAX frame loop's shard with the same per-device keys."""
    mesh = jax_make_mesh()
    px, py, _ = pixel_grid(W, H, pad_to=N)
    draws = ThreefryDraws(4, 0)
    ranks = draws.split(N)
    keys = jnp.stack([d.key for d in ranks])
    want = jax_render.make_sharded_frame_loop(mesh, JaxBrute(), W, H,
                                              recursions=0)(
        scenes["jdev"], scenes["jcam"], jnp.asarray(px), jnp.asarray(py),
        keys, jnp.int32(2))
    for view in _views():
        frame = make_sharded_frame_loop(view, BruteForceIntersector(), W, H,
                                        recursions=0)
        got = frame(scenes["pdev"], scenes["pcam"], px, py, ranks, 2)
        sl = ray_sharding(view, len(px))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w)[sl],
                                       rtol=1e-5, atol=1e-6)


def test_mesh_without_a_process_group():
    """One process, nothing configured: the mesh is one rank with no
    group; a larger mesh needs a group, and a one-rank view of one
    refuses collectives."""
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert make_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError, match="process group"):
        make_mesh(N, device="cpu")
    assert ray_sharding(Mesh(4, 2, torch.device("cpu")), 12) == slice(6, 9)
    assert replicated(mesh) == slice(None)
    with pytest.raises(ValueError, match="divide"):
        ray_sharding(Mesh(4, 0, torch.device("cpu")), 10)
    with pytest.raises(ValueError, match="outside"):
        Mesh(2, 2, torch.device("cpu"))
    x = torch.ones((3, 3))
    assert all_gather_rays(mesh, x) is x
    with pytest.raises(ValueError, match="one-rank view"):
        all_gather_rays(_views()[1], x)


def test_initialize_distributed_single_process(monkeypatch):
    """Nothing configured: False, and no process group starts."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_distributed_raises_on_bad_bring_up():
    """A rank outside the world raises before any connection; a store
    that nobody serves raises within the init timeout, not hangs."""
    with pytest.raises(ValueError, match="outside"):
        initialize_distributed(init_method="tcp://127.0.0.1:1", world_size=2,
                               rank=2, device="cpu", timeout=5)
    with pytest.raises(torch.distributed.DistError):
        initialize_distributed(
            init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=2,
            rank=1, device="cpu", timeout=2)
    assert not torch.distributed.is_initialized()


def test_sharded_train_step_matches_reference_and_reduces_loss(scenes):
    """tests/test_parallel.py:77-106 at one rank: 12 Adam steps over the
    albedo from grey lower the loss below half, and the losses follow the
    JAX sharded step's on a one-device mesh with the same keys
    (torch.optim.Adam and optax.adam order their arithmetic differently:
    rtol 1e-3, as tests/test_torch_diff.py holds them)."""
    jmesh = jax_make_mesh(1)
    px, py, _ = pixel_grid(W, H)
    key = jax.random.PRNGKey(1)

    def ranks():
        return [ThreefryDraws(None, 0, key=key)]

    jkeys = _first_sample_keys(ranks())
    target_j = jax_render.make_sharded_render(jmesh, JaxBrute(), W, H,
                                              recursions=0)(
        scenes["jdev"], scenes["jcam"], jnp.asarray(px), jnp.asarray(py),
        jkeys)
    mesh = make_mesh(device="cpu")
    with torch.no_grad():
        target = make_sharded_render(mesh, BruteForceIntersector(), W, H,
                                     recursions=0)(
            scenes["pdev"], scenes["pcam"], px, py, ranks())
    np.testing.assert_allclose(target.numpy(), np.asarray(target_j),
                               rtol=1e-5, atol=1e-6)

    start = dataclasses.replace(scenes["pdev"], mat_diffuse_rgb=torch.full_like(
        scenes["pdev"].mat_diffuse_rgb, 0.5))
    params = extract_params(start, ("mat_diffuse_rgb",))
    opt = torch.optim.Adam(list(params.values()), lr=5e-2)
    step = make_sharded_train_step(mesh, BruteForceIntersector(), W, H, opt,
                                   recursions=0)
    losses = []
    for _ in range(12):
        loss, params = step(params, start, scenes["pcam"], px, py, target,
                            ranks())
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses

    jopt = optax.adam(5e-2)
    jstep = jax_render.make_sharded_train_step(jmesh, JaxBrute(), W, H, jopt,
                                               recursions=0)
    jstart = dataclasses.replace(scenes["jdev"], mat_diffuse_rgb=jnp.full_like(
        scenes["jdev"].mat_diffuse_rgb, 0.5))
    diff = {"mat_diffuse_rgb": jstart.mat_diffuse_rgb}
    state = jopt.init(diff)
    jlosses = []
    for _ in range(12):
        loss, state, diff = jstep(state, diff, jstart, scenes["jcam"],
                                  jnp.asarray(px), jnp.asarray(py), target_j,
                                  jkeys)
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(params["mat_diffuse_rgb"].detach().numpy(),
                               np.asarray(diff["mat_diffuse_rgb"]), rtol=1e-3,
                               atol=1e-5)


def test_sharded_train_step_over_the_bvh_equals_the_unsharded_step(scenes,
                                                                   data_dir):
    """The sharded train step over the BVH (the dry run's intersector) at
    one rank against diff.inverse.make_train_step over the same BVH,
    from the same start and draws, with two bounces: the loss, the
    albedo gradient and the updated albedo within rtol 1e-5."""
    from raytracer_tpu_torch.core.intersectors import make_intersector
    from raytracer_tpu_torch.diff.inverse import make_train_step
    buf = ColladaLoader.from_file(data_dir / "4boxes.dae",
                                  verbose=False).to_buffers()
    bvh = make_intersector("bvh", buf, device="cpu")
    mesh = make_mesh(device="cpu")
    px, py, _ = pixel_grid(W, H)
    key = jax.random.PRNGKey(2)

    def ranks():
        return [ThreefryDraws(None, 2, key=key)]

    with torch.no_grad():
        target = make_sharded_render(mesh, bvh, W, H, recursions=2)(
            scenes["pdev"], scenes["pcam"], px, py, ranks())
    start = dataclasses.replace(scenes["pdev"], mat_diffuse_rgb=torch.full_like(
        scenes["pdev"].mat_diffuse_rgb, 0.5))
    out = []
    for sharded in (True, False):
        params = extract_params(start, ("mat_diffuse_rgb",))
        opt = torch.optim.Adam(list(params.values()), lr=5e-2)
        if sharded:
            loss, params = make_sharded_train_step(mesh, bvh, W, H, opt,
                                                   recursions=2)(
                params, start, scenes["pcam"], px, py, target, ranks())
        else:
            params, loss = make_train_step(
                opt, scenes["pcam"], torch.from_numpy(px),
                torch.from_numpy(py), W, H, bvh, target, recursions=2)(
                params, start, ranks()[0])
        p = params["mat_diffuse_rgb"]
        out.append((float(loss), p.grad.numpy().copy(),
                    p.detach().numpy().copy()))
    (loss_s, grad_s, p_s), (loss_u, grad_u, p_u) = out
    assert np.isfinite(loss_s) and loss_s > 0
    assert np.abs(grad_u).max() > 0
    np.testing.assert_allclose(loss_s, loss_u, rtol=1e-5)
    np.testing.assert_allclose(grad_s, grad_u, rtol=1e-5,
                               atol=1e-7 * np.abs(grad_u).max())
    np.testing.assert_allclose(p_s, p_u, rtol=1e-5)


def test_dry_run_trains_over_the_bvh_on_two_gloo_ranks():
    """`python -m raytracer_tpu_torch.parallel.dryrun --ranks 2 --device
    cpu`: two worker processes over gloo render over the BVH and brute
    force and take one sharded train step over the BVH."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.parallel.dryrun",
         "--ranks", "2", "--device", "cpu", "--timeout", "50"],
        cwd=root, env=env, capture_output=True, text=True, timeout=60)
    text = out.stdout + out.stderr
    assert out.returncode == 0, text
    assert "dryrun: 2 of 2 ranks OK" in out.stdout, text
    for rank in (0, 1):
        assert f"dryrun_multichip(2) rank {rank}: OK" in out.stdout, text
