"""The port's differentiable rendering (diff/) against the JAX package's:
the same scenes, parameters and threefry draws through both, pixel
radiance and gradients held against each other, the finite-difference
checks of tests/test_diff.py and tests/test_texture_grad.py on the port,
inverse rendering, and the refusal of the kernel intersectors under
autograd.

Tolerance of the gradient comparison: the two packages write
Moller-Trumbore and the shading dot products in different operation
orders (jnp.cross/einsum against the kernels' component form), so their
gradients agree to float32 rounding of a few dozen operations, not bit
for bit: rtol 1e-3 on each entry, atol 1e-5 of the largest entry's
magnitude (entries that are zero on one side are tiny on the other)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.core.intersectors import BruteForceIntersector as JaxBrute
from raytracer_tpu.diff import gradients as jgrad
from raytracer_tpu.diff.inverse import optimize as jax_optimize
from raytracer_tpu.models.collada import ColladaLoader as JaxLoader
from raytracer_tpu_torch.core.intersect import closest_hit
from raytracer_tpu_torch.core.intersectors import (BruteForceIntersector,
                                                   make_intersector)
from raytracer_tpu_torch.core.wavefront import _unsort_radiance
from raytracer_tpu_torch.diff.gradients import (pixel_loss, render_pixels,
                                                scene_grads)
from raytracer_tpu_torch.diff.inverse import optimize, params_from_numpy
from raytracer_tpu_torch.models.camera import CameraParams
from raytracer_tpu_torch.models.types import SceneArrays
from tests import fixtures
from tests.test_torch_wavefront import ThreefryStream

RTOL, ATOL_REL = 1e-3, 1e-5


class KeyDraws:
    """One sample from a fixed key, as the JAX render_pixels splits it
    (diff/gradients.py:37-39): kj, kt = split(key); jitter from kj, the
    Gaussians from kt.  Every call of next_sample gives the same sample,
    so a loss evaluated twice sees the same draws (the JAX key's
    semantics)."""

    def __init__(self, key, recursions):
        self.key = key
        self.recursions = recursions

    def next_sample(self, n):
        kj, kt = jax.random.split(self.key)
        jitter = jax.random.uniform(kj, (n, 2), dtype=jnp.float32)
        return (torch.from_numpy(np.array(jitter)),
                ThreefryStream(kt, self.recursions))


def _both(jscene, W, H, recursions=0):
    """Both packages' inputs from one JAX scene: scene arrays, camera
    params, pixels, a fixed jitter, the key."""
    jdev = jscene.to_buffers().to_device()
    jcam = jscene.cameras[0].params()
    px = np.tile(np.arange(W, dtype=np.int32), H)
    py = np.repeat(np.arange(H, dtype=np.int32), W)
    jitter = np.full((W * H, 2), 0.5, np.float32)
    key = jax.random.PRNGKey(0)
    port = dict(
        scene=SceneArrays.from_numpy(
            {f.name: np.array(getattr(jdev, f.name))
             for f in dataclasses.fields(jdev)}, device="cpu"),
        cam=CameraParams.from_numpy(
            {n: np.array(getattr(jcam, n))
             for n in ("rot", "origin", "max_x", "max_y")}, device="cpu"),
        px=torch.from_numpy(px), py=torch.from_numpy(py),
        jitter=torch.from_numpy(jitter),
        draws=lambda: KeyDraws(key, recursions))
    jax_in = dict(scene=jdev, cam=jcam, px=jnp.asarray(px), py=jnp.asarray(py),
                  jitter=jnp.asarray(jitter), key=key)
    return port, jax_in


@pytest.fixture(scope="module")
def tri_scene():
    """tests/test_diff.py's wall triangle at scene y = -4, lit from
    behind its normal's side, 16x12 pixels."""
    doc = fixtures.make_doc(
        positions=[-2, -1, 4, 2, -1, 4, 0, 2, 4], indices=[0, 1, 2],
        light_matrix=fixtures.translate_matrix(0.5, 1.0, -6.0),
        light_color="5 5 5", diffuse="0.6 0.3 0.2 1")
    return _both(JaxLoader.from_str(doc, verbose=False), 16, 12)


@pytest.fixture(scope="module")
def tex_scene(data_dir):
    """tests/test_texture_grad.py's textured sphere, 24x18 pixels."""
    scene = JaxLoader.from_file(data_dir / "ico3_tex.dae", width=24,
                                height=18, verbose=False)
    return _both(scene, 24, 18)


def _port_render(p, W, H, recursions=0, scene=None, cam=None, draws=None):
    return render_pixels(scene or p["scene"], cam or p["cam"], p["px"],
                         p["py"], draws or p["draws"](), W, H,
                         BruteForceIntersector(), recursions=recursions,
                         jitter=p["jitter"])


def _jax_render(j, W, H, recursions=0):
    return np.asarray(jgrad.render_pixels(
        j["scene"], j["cam"], j["px"], j["py"], j["key"], W, H, JaxBrute(),
        recursions=recursions, jitter=j["jitter"]))


@pytest.mark.parametrize("recursions", [0, 2])
def test_render_pixels_matches_reference(data_dir, recursions):
    """render_pixels through both packages with the same threefry draws:
    exact to float32 rounding at recursions 0, under the flip rule (at
    most 24 values beyond rtol 2e-4, tests/test_fused_spawn.py:56-62)
    with two bounces."""
    W, H = 16, 12
    p, j = _both(JaxLoader.from_file(data_dir / "4boxes.dae", width=W,
                                     height=H, verbose=False), W, H,
                 recursions)
    want = _jax_render(j, W, H, recursions)
    got = _port_render(p, W, H, recursions).numpy()
    assert got.shape == want.shape == (W * H, 3) and want.max() > 0
    if recursions == 0:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert (~close).sum() <= 24, f"{(~close).sum()} of {close.size} differ"


def _assert_grads_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.abs(want).max() > 0, what
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max(),
                               err_msg=what)


def _jax_grads(j, W, H, target, recursions=0):
    def loss(s, c):
        return jgrad.pixel_loss(s, c, j["px"], j["py"], j["key"], W, H,
                                JaxBrute(), jnp.asarray(target),
                                recursions=recursions, jitter=j["jitter"])
    return jax.grad(loss, argnums=(0, 1), allow_int=True)(j["scene"],
                                                          j["cam"])


def _port_grads(p, W, H, target, recursions=0):
    return scene_grads(p["scene"], p["cam"], p["px"], p["py"], p["draws"](),
                       W, H, BruteForceIntersector(),
                       torch.from_numpy(target), recursions=recursions,
                       jitter=p["jitter"])


def test_gradients_match_jax_grad_on_the_wall_triangle(tri_scene):
    """Albedo, vertices, light colour and position, camera origin and
    rotation: the port's autograd against jax.grad of the same loss."""
    p, j = tri_scene
    W, H = 16, 12
    target = _jax_render(j, W, H) * np.float32(0.8)
    jg_s, jg_c = _jax_grads(j, W, H, target)
    pg_s, pg_c = _port_grads(p, W, H, target)
    for name in ("mat_diffuse_rgb", "tri_verts", "light_color", "light_pos"):
        _assert_grads_close(getattr(pg_s, name), getattr(jg_s, name), name)
    for name in ("origin", "rot"):
        _assert_grads_close(getattr(pg_c, name), getattr(jg_c, name), name)
    assert pg_s.tri_geom is None and pg_s.tex_hw is None
    assert float(pg_s.mat_emissive.abs().sum()) == 0.0


def test_gradients_match_jax_grad_on_texels(tex_scene):
    """tests/test_texture_grad.py's scene: the texel gradients (through
    the nearest-neighbour fetch) against jax.grad, and every other float
    leaf the loss reaches."""
    p, j = tex_scene
    W, H = 24, 18
    target = _jax_render(j, W, H) * np.float32(0.7)
    jg_s, _ = _jax_grads(j, W, H, target)
    pg_s, _ = _port_grads(p, W, H, target)
    for name in ("tex_atlas", "mat_diffuse_rgb", "tri_verts", "light_color"):
        _assert_grads_close(getattr(pg_s, name), getattr(jg_s, name), name)
    g = pg_s.tex_atlas.numpy()
    assert (np.abs(g) > 1e-10).any(), "no texel received gradient"


def _loss(p, W, H, target, scene=None, cam=None):
    return pixel_loss(scene or p["scene"], cam or p["cam"], p["px"], p["py"],
                      p["draws"](), W, H, BruteForceIntersector(),
                      torch.from_numpy(target), jitter=p["jitter"])


@pytest.mark.parametrize("leaf,idx,eps,rtol", [
    ("mat_diffuse_rgb", 0, 1e-3, 0.05),
    ("tri_verts", 0, 1e-3, 0.08),
    ("light_color", 1, 1e-3, 0.05),
    ("origin", 2, 1e-3, 0.08),
])
def test_grad_matches_finite_differences(tri_scene, leaf, idx, eps, rtol):
    """The port of tests/test_diff.py's four central finite-difference
    checks (same entries, steps and tolerances)."""
    p, j = tri_scene
    W, H = 16, 12
    target = _port_render(p, W, H).detach().numpy() * np.float32(0.8)
    gs, gc = _port_grads(p, W, H, target)
    on_cam = leaf == "origin"
    analytic = float(getattr(gc if on_cam else gs, leaf).reshape(-1)[idx])

    def perturbed(delta):
        obj = p["cam"] if on_cam else p["scene"]
        t = getattr(obj, leaf).clone()
        t.view(-1)[idx] += delta
        obj = dataclasses.replace(obj, **{leaf: t})
        with torch.no_grad():
            return float(_loss(p, W, H, target, **(
                {"cam": obj} if on_cam else {"scene": obj})))

    fd = (perturbed(eps) - perturbed(-eps)) / (2 * eps)
    assert analytic == pytest.approx(fd, rel=rtol, abs=1e-6), \
        f"analytic {analytic} vs fd {fd}"
    if leaf == "mat_diffuse_rgb":
        assert analytic != 0.0


def test_texel_grad_matches_finite_differences(tex_scene):
    """The port of tests/test_texture_grad.py: texel gradients finite,
    some nonzero, and the largest one equal to its central difference
    (eps 1e-2, rel 0.05); zeroing the texture changes the image."""
    p, _ = tex_scene
    W, H = 24, 18
    with torch.no_grad():
        base = _port_render(p, W, H)
        dark = _port_render(p, W, H, scene=dataclasses.replace(
            p["scene"], tex_atlas=torch.zeros_like(p["scene"].tex_atlas)))
    assert float((base - dark).abs().max()) > 1e-3
    target = base.numpy() * np.float32(0.7)
    g = _port_grads(p, W, H, target)[0].tex_atlas.numpy()
    assert np.isfinite(g).all() and (np.abs(g) > 1e-10).any()
    idx = int(np.abs(g).reshape(-1).argmax())
    eps = 1e-2

    def perturbed(delta):
        a = p["scene"].tex_atlas.clone()
        a.view(-1)[idx] += delta
        with torch.no_grad():
            return float(_loss(p, W, H, target, scene=dataclasses.replace(
                p["scene"], tex_atlas=a)))

    fd = (perturbed(eps) - perturbed(-eps)) / (2 * eps)
    assert g.reshape(-1)[idx] == pytest.approx(fd, rel=0.05)


def test_inverse_rendering_recovers_albedo(tri_scene):
    """tests/test_diff.py:119-139 on the port (120 Adam steps at 5e-2
    from an albedo of 0.5: the albedo within 0.05, the loss down 100x),
    and the first 10 losses against the JAX optimize's from the same
    start.  torch.optim.Adam and optax.adam order their arithmetic
    differently, so the losses agree to rtol 1e-3, not bit for bit."""
    p, j = tri_scene
    W, H = 16, 12
    target_j = jgrad.render_pixels(j["scene"], j["cam"], j["px"], j["py"],
                                   j["key"], W, H, JaxBrute(), recursions=0,
                                   jitter=j["jitter"])
    target = torch.from_numpy(np.array(target_j))
    start_p = dataclasses.replace(p["scene"], **params_from_numpy(
        {"mat_diffuse_rgb": np.full((1, 3), 0.5, np.float32)}, device="cpu"))
    recovered, losses = optimize(
        start_p, p["cam"], p["px"], p["py"], W, H, BruteForceIntersector(),
        target, fields=("mat_diffuse_rgb",), steps=120, learning_rate=5e-2,
        jitter=p["jitter"], draws=KeyDraws(j["key"], 0))
    assert losses[-1] < losses[0] * 1e-2
    np.testing.assert_allclose(recovered.mat_diffuse_rgb.numpy(),
                               np.asarray(j["scene"].mat_diffuse_rgb),
                               atol=0.05)
    start_j = dataclasses.replace(
        j["scene"], mat_diffuse_rgb=jnp.full_like(j["scene"].mat_diffuse_rgb,
                                                  0.5))
    _, jlosses = jax_optimize(start_j, j["cam"], j["px"], j["py"], W, H,
                              JaxBrute(), target_j,
                              fields=("mat_diffuse_rgb",), steps=10,
                              learning_rate=5e-2, jitter=j["jitter"])
    np.testing.assert_allclose(losses[:10], jlosses, rtol=1e-3)


@pytest.mark.parametrize("kind", ["bvh", "cluster"])
def test_kernel_intersectors_refuse_autograd(tri_scene, data_dir, kind):
    """A kernel intersector has no backward: under autograd it raises a
    ValueError naming the brute-force path, whether the scene or the
    rays require grad; under no_grad it renders."""
    from raytracer_tpu_torch.models.collada import ColladaLoader
    p, _ = tri_scene
    W, H = 16, 12
    sb = ColladaLoader.from_file(data_dir / "4boxes.dae",
                                 verbose=False).to_buffers()
    isect = make_intersector(kind, sb, device="cpu")
    target = np.zeros((W * H, 3), np.float32)
    with pytest.raises(ValueError, match="brute"):
        scene_grads(p["scene"], p["cam"], p["px"], p["py"], p["draws"](), W,
                    H, isect, torch.from_numpy(target))
    o = torch.zeros((4, 3), requires_grad=True)
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match="brute"):
        isect.query(None, o, d)
    with pytest.raises(ValueError, match="brute"):
        isect.shadow(None, o, d)
    with torch.no_grad():
        assert isect.query(None, o, d)["t"].shape == (4,)


def test_fused_wavefront_refuses_autograd(data_dir):
    """The fused path (spawn and shadow-shade) raises too, whether a
    scene tensor or a kernel operand requires grad."""
    import raytracer_tpu_torch as rtx
    rt = rtx.create_raytracer_from_file(str(data_dir / "4boxes.dae"),
                                        width=8, height=8, device="cpu")
    assert rt.fused
    rt.scene_arrays.mat_diffuse_rgb.requires_grad_(True)
    with pytest.raises(ValueError, match="brute"):
        rt.render(1)
    rt.scene_arrays.mat_diffuse_rgb.requires_grad_(False)
    isect = rt.intersector
    rays = torch.zeros((6, 4), requires_grad=True)
    with pytest.raises(ValueError, match="brute"):
        isect.spawn(rays, torch.zeros((0, 4)), rt.scene_arrays.light_pos, 0)
    with pytest.raises(ValueError, match="brute"):
        isect.shadow_shade(rays, *(torch.zeros((3, 4)),) * 3,
                           rt.scene_arrays.light_color)


def test_recomputed_winner_equals_the_selection():
    """Under autograd the closest hit recomputes t/u/v for the winning
    triangle only: the values equal the no-grad scan's bit for bit, over
    several triangle and ray chunks, and gradients reach the vertices
    and the rays."""
    rng = np.random.default_rng(11)
    tris = (rng.uniform(-3, 3, (300, 1, 3))
            + rng.uniform(-0.6, 0.6, (300, 3, 3))).astype(np.float32)
    o = torch.from_numpy(rng.uniform(-5, 5, (700, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(700, 3)).astype(np.float32))
    tv = torch.from_numpy(tris)
    want = closest_hit(o, d, tv, chunk=64)
    assert bool(want["hit"].any()) and not bool(want["hit"].all())
    same_chunks = closest_hit(o, d, tv, chunk=64, ray_chunk=97)
    tvg = tv.clone().requires_grad_(True)
    og = o.clone().requires_grad_(True)
    got = closest_hit(og, d, tvg, chunk=64, ray_chunk=97)
    for k in ("t", "u", "v", "tri", "hit"):
        assert torch.equal(same_chunks[k], want[k]), k
        assert torch.equal(got[k].detach(), want[k]), k
    hit = want["hit"]
    (got["t"][hit].sum() + got["u"][hit].sum()).backward()
    assert bool(tvg.grad.abs().sum() > 0) and bool(og.grad.abs().sum() > 0)
    assert bool((og.grad[~hit] == 0).all())


def test_unsort_radiance_carries_gradients():
    """The radiance unsort is an out-of-place scatter: gradients reach
    the sorted radiance, each row from the row it lands in."""
    rad = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    rad.requires_grad_(True)
    orig = torch.tensor([2, 0, 3, 1])
    out = _unsort_radiance(rad, orig)
    assert torch.equal(out[orig], rad.detach())
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1.0
    (out * w).sum().backward()
    assert torch.equal(rad.grad, w[orig])
