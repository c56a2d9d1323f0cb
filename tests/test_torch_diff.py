"""The port's differentiable rendering (diff/) against the JAX package's:
the same scenes, parameters and threefry draws through both, pixel
radiance and gradients held against each other, the finite-difference
checks of tests/test_diff.py and tests/test_texture_grad.py on the port,
inverse rendering, the gradients through the kernel intersectors (the
BVH and the cluster grid, against the JAX package's XLA path), and the
refusal of the paths that have no gradient.

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
from raytracer_tpu.core.intersectors import (
    make_intersector as jax_make_intersector)
from raytracer_tpu.diff import gradients as jgrad
from raytracer_tpu.diff.inverse import optimize as jax_optimize
from raytracer_tpu.models.collada import ColladaLoader as JaxLoader
from raytracer_tpu_torch.core.intersect import closest_hit
from raytracer_tpu_torch.core.intersectors import (BruteForceIntersector,
                                                   make_intersector)
from raytracer_tpu_torch.core.shade import build_slot_records
from raytracer_tpu_torch.core.wavefront import (_unsort_radiance,
                                                trace_radiance)
from raytracer_tpu_torch.diff.gradients import (_with_grad, pixel_loss,
                                                render_pixels, scene_grads)
from raytracer_tpu_torch.diff.inverse import optimize, params_from_numpy
from raytracer_tpu_torch.models.camera import CameraParams
from raytracer_tpu_torch.models.types import SceneArrays
from tests import fixtures
from tests.test_torch_wavefront import ThreefryStream
from tests.test_torch_wavefront import torch_threads  # noqa: F401 (autouse)

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


def _wall():
    """tests/test_diff.py's wall triangle at scene y = -4, lit from
    behind its normal's side, as a JAX scene."""
    doc = fixtures.make_doc(
        positions=[-2, -1, 4, 2, -1, 4, 0, 2, 4], indices=[0, 1, 2],
        light_matrix=fixtures.translate_matrix(0.5, 1.0, -6.0),
        light_color="5 5 5", diffuse="0.6 0.3 0.2 1")
    return JaxLoader.from_str(doc, verbose=False)


@pytest.fixture(scope="module")
def tri_scene():
    """The wall triangle at 16x12 pixels."""
    return _both(_wall(), 16, 12)


@pytest.fixture(scope="module")
def tex_scene(data_dir):
    """tests/test_texture_grad.py's textured sphere, 24x18 pixels."""
    scene = JaxLoader.from_file(data_dir / "ico3_tex.dae", width=24,
                                height=18, verbose=False)
    return _both(scene, 24, 18)


def _port_render(p, W, H, recursions=0, scene=None, cam=None, draws=None,
                 isect=None):
    return render_pixels(scene or p["scene"], cam or p["cam"], p["px"],
                         p["py"], draws or p["draws"](), W, H,
                         isect or BruteForceIntersector(),
                         recursions=recursions, jitter=p["jitter"])


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


def _jax_grads(j, W, H, target, recursions=0, isect=None):
    def loss(s, c):
        return jgrad.pixel_loss(s, c, j["px"], j["py"], j["key"], W, H,
                                isect or JaxBrute(), jnp.asarray(target),
                                recursions=recursions, jitter=j["jitter"])
    return jax.grad(loss, argnums=(0, 1), allow_int=True)(j["scene"],
                                                          j["cam"])


def _port_grads(p, W, H, target, recursions=0, isect=None):
    return scene_grads(p["scene"], p["cam"], p["px"], p["py"], p["draws"](),
                       W, H, isect or BruteForceIntersector(),
                       torch.from_numpy(target), recursions=recursions,
                       jitter=p["jitter"])


@pytest.fixture(scope="module")
def tri_render(tri_scene):
    """The JAX render of the wall triangle (recursions 0, fixed jitter),
    computed once for the tests that derive their targets from it."""
    return _jax_render(tri_scene[1], 16, 12)


def test_gradients_match_jax_grad_on_the_wall_triangle(tri_scene,
                                                       tri_render):
    """Albedo, vertices, light colour and position, camera origin and
    rotation: the port's autograd against jax.grad of the same loss."""
    p, j = tri_scene
    W, H = 16, 12
    target = tri_render * np.float32(0.8)
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


@pytest.fixture(scope="module")
def tri_fd(tri_scene):
    """The finite-difference checks' target (the port's render x 0.8)
    and the port's gradients of its loss, computed once."""
    p, _ = tri_scene
    target = _port_render(p, 16, 12).detach().numpy() * np.float32(0.8)
    return target, _port_grads(p, 16, 12, target)


@pytest.mark.parametrize("leaf,idx,eps,rtol", [
    ("mat_diffuse_rgb", 0, 1e-3, 0.05),
    ("tri_verts", 0, 1e-3, 0.08),
    ("light_color", 1, 1e-3, 0.05),
    ("origin", 2, 1e-3, 0.08),
])
def test_grad_matches_finite_differences(tri_scene, tri_fd, leaf, idx, eps,
                                         rtol):
    """The port of tests/test_diff.py's four central finite-difference
    checks (same entries, steps and tolerances)."""
    p, j = tri_scene
    W, H = 16, 12
    target, (gs, gc) = tri_fd
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


def test_inverse_rendering_recovers_albedo(tri_scene, tri_render):
    """tests/test_diff.py:119-139 on the port (120 Adam steps at 5e-2
    from an albedo of 0.5: the albedo within 0.05, the loss down 100x),
    and the first 10 losses against the JAX optimize's from the same
    start.  torch.optim.Adam and optax.adam order their arithmetic
    differently, so the losses agree to rtol 1e-3, not bit for bit."""
    p, j = tri_scene
    W, H = 16, 12
    target_j = jnp.asarray(tri_render)
    target = torch.from_numpy(np.array(tri_render))
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


KINDS = ["bvh", "cluster"]
SCENE_LEAVES = ("mat_diffuse_rgb", "tri_verts", "light_color", "light_pos")
CAMERA_LEAVES = ("origin", "rot")


def _isects(buf, kind):
    """The accel `kind` of both packages over the same scene buffers: the
    JAX one takes its XLA path on the CPU (no Pallas, no interpret mode),
    the port's runs the kernels' plain versions."""
    return (jax_make_intersector(kind, buf),
            make_intersector(kind, buf, device="cpu"))


@pytest.fixture(scope="module")
def boxes(data_dir):
    """4boxes at 16x12 with one bounce: both packages' inputs and the
    scene buffers the intersectors are built from."""
    js = JaxLoader.from_file(data_dir / "4boxes.dae", width=16, height=12,
                             verbose=False)
    p, j = _both(js, 16, 12, recursions=1)
    return p, j, js.to_buffers()


@pytest.fixture(scope="module")
def boxes_grads(boxes):
    """get(side, kind): the gradients of the zero-target loss on 4boxes
    of package `side` ("jax" or "port") over intersector `kind`
    ("brute", "bvh", "cluster"), each computed once."""
    p, j, buf = boxes
    target = np.zeros((16 * 12, 3), np.float32)
    cache = {}

    def get(side, kind):
        if (side, kind) not in cache:
            isect = (None if kind == "brute"
                     else _isects(buf, kind)[side == "port"])
            fn = _jax_grads if side == "jax" else _port_grads
            cache[side, kind] = fn(p if side == "port" else j, 16, 12,
                                   target, 1, isect)
        return cache[side, kind]
    return get


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_intersector_gradients_match_jax(boxes_grads, kind):
    """scene_grads over the port's BVH and cluster grid against jax.grad
    over the JAX package's (its XLA path) on 4boxes with one bounce:
    every float leaf the loss reaches, within the file's tolerance."""
    jg_s, jg_c = boxes_grads("jax", kind)
    pg_s, pg_c = boxes_grads("port", kind)
    for name in SCENE_LEAVES:
        _assert_grads_close(getattr(pg_s, name), getattr(jg_s, name),
                            f"{kind} {name}")
    for name in CAMERA_LEAVES:
        _assert_grads_close(getattr(pg_c, name), getattr(jg_c, name),
                            f"{kind} {name}")
    assert pg_s.tri_geom is None


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_vertex_gradients_follow_the_accelerated_path(boxes_grads,
                                                             kind):
    """Over an accel, t comes from the intersector's own copy of the
    triangles, so the vertex gradient differs from brute force's (which
    reaches the vertices through t as well): in the JAX package (max
    |delta| about 0.18 of a largest entry of 1.35 on this scene) and in
    the port alike, while every other leaf agrees with brute force."""
    def far(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max()) > 0.05 * float(np.abs(b).max())
    for side in ("jax", "port"):
        accel, brute = boxes_grads(side, kind)[0], boxes_grads(side,
                                                               "brute")[0]
        assert far(accel.tri_verts, brute.tri_verts), side
        _assert_grads_close(accel.mat_diffuse_rgb, brute.mat_diffuse_rgb,
                            f"{side} albedo")
        _assert_grads_close(accel.light_pos, brute.light_pos,
                            f"{side} light_pos")


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_intersector_texel_gradients_match_jax(tex_scene, data_dir,
                                                      kind):
    """The textured ico3_tex at 24x18 over each accel: the texel
    gradients (through the nearest-neighbour fetch at the recomputed u,
    v) and the other float leaves against jax.grad over the same accel
    of the JAX package."""
    p, j = tex_scene
    W, H = 24, 18
    buf = JaxLoader.from_file(data_dir / "ico3_tex.dae", width=W, height=H,
                              verbose=False).to_buffers()
    jisect, pisect = _isects(buf, kind)
    target = _jax_render(j, W, H) * np.float32(0.7)
    jg_s, _ = _jax_grads(j, W, H, target, isect=jisect)
    pg_s, _ = _port_grads(p, W, H, target, isect=pisect)
    for name in ("tex_atlas", "mat_diffuse_rgb", "tri_verts", "light_color"):
        _assert_grads_close(getattr(pg_s, name), getattr(jg_s, name),
                            f"{kind} {name}")
    assert (np.abs(pg_s.tex_atlas.numpy()) > 1e-10).any()


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_forward_under_autograd_is_bitwise(boxes, kind):
    """Under autograd a kernel intersector's values are the selection's
    bit for bit: a query with rays that require grad against the same
    query under no_grad, and the radiance of render_pixels with every
    scene and camera leaf requiring grad against the no_grad render."""
    p, _, buf = boxes
    isect = _isects(buf, kind)[1]
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(-2, 2, (500, 3)).astype(np.float32))
    o[:, 1] += 3.0
    d = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    alive = torch.from_numpy(rng.random(500) > 0.2)
    with torch.no_grad():
        want = isect.query(None, o, d, alive=alive)
    got = isect.query(None, o.clone().requires_grad_(True),
                      d.clone().requires_grad_(True), alive=alive)
    assert bool(want["hit"].any()) and not bool(want["hit"].all())
    for k in ("t", "u", "v"):
        assert got[k].requires_grad and torch.equal(_bits(got[k]),
                                                    _bits(want[k])), k
    for k in ("hit", "slot", "tri"):
        assert torch.equal(got[k], want[k]), k
    with torch.no_grad():
        rad = _port_render(p, 16, 12, recursions=1, isect=isect)
    rad_g = _port_render(p, 16, 12, recursions=1,
                         scene=_with_grad(p["scene"]), cam=_with_grad(p["cam"]),
                         isect=isect)
    assert rad_g.requires_grad and float(rad.max()) > 0
    assert torch.equal(_bits(rad_g), _bits(rad))


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_ray_gradients_equal_brute_force_and_stay_finite(kind):
    """The ray gradient through a kernel intersector's closest hit equals
    brute force's on the same triangles (the same winner, the same
    Moller-Trumbore), and missed and dead rays get a zero gradient, not
    NaN, even with a dead ray's origin at infinity."""
    from types import SimpleNamespace
    rng = np.random.default_rng(11)
    tris = (rng.uniform(-3, 3, (300, 1, 3))
            + rng.uniform(-0.6, 0.6, (300, 3, 3))).astype(np.float32)
    isect = make_intersector(kind, SimpleNamespace(tri_verts=tris),
                             device="cpu")
    o = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    d = rng.normal(size=(700, 3)).astype(np.float32)
    alive = rng.random(700) > 0.25
    o[np.flatnonzero(~alive)[:5]] = np.inf
    o, d, alive = (torch.from_numpy(a) for a in (o, d, alive))
    og, dg = (a.clone().requires_grad_(True) for a in (o, d))
    got = isect.query(None, og, dg, alive=alive)
    hit = got["hit"]
    assert bool(hit.any()) and bool((alive & ~hit).any())
    assert not bool(hit[~alive].any())
    (got["t"][hit].sum() + 0.5 * got["u"][hit].sum()
     + 0.25 * got["v"][hit].sum() + got["t"][~hit].sum()
     + got["u"][~hit].sum()).backward()
    for g in (og.grad, dg.grad):
        assert bool(torch.isfinite(g).all()) and bool((g[~hit] == 0).all())
    # brute force on the live rays (it has no alive mask)
    bo, bd = (a[alive].clone().requires_grad_(True) for a in (o, d))
    want = closest_hit(bo, bd, torch.from_numpy(tris))
    assert torch.equal(want["hit"], hit[alive])
    assert torch.equal(got["t"][alive].detach(), want["t"])
    wh = want["hit"]
    (want["t"][wh].sum() + 0.5 * want["u"][wh].sum()
     + 0.25 * want["v"][wh].sum()).backward()
    for g, w in ((og.grad[alive], bo.grad), (dg.grad[alive], bd.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


class _CountingQueries:
    """An intersector that records (rays, alive, hit) of every closest
    query it forwards."""

    def __init__(self, isect):
        self.isect, self.seen = isect, []

    def __getattr__(self, name):
        return getattr(self.isect, name)

    def query(self, scene, origins, dirs, alive=None, **kw):
        res = self.isect.query(scene, origins, dirs, alive=alive, **kw)
        self.seen.append((origins.shape[0], int(alive.sum()),
                          int(res["hit"].sum())))
        return res


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_gradients_finite_where_most_rays_miss(kind):
    """The wall triangle with two bounces: most rays miss (a triangle
    alone rarely sees itself) and every child of a missed parent is
    dead, yet every gradient over the kernel intersectors is finite, and
    every leaf but the vertices equals brute force's.  (The JAX
    package's XLA accel path renders 21 of these 576 values otherwise
    than its own brute force, at the wall's zero-thickness box; the
    port's accels render as brute force does, so brute force is the
    yardstick here.)"""
    W, H = 16, 12
    js = _wall()
    p, _ = _both(js, W, H, recursions=2)
    pisect = make_intersector(kind, js.to_buffers(), device="cpu")
    counting = _CountingQueries(pisect)
    with torch.no_grad():
        rad = _port_render(p, W, H, recursions=2, isect=counting)
    (n0, _, hit0), (n1, alive1, hit1), (n2, alive2, hit2) = counting.seen
    # 120 of 192 primary rays hit; 7 of their 240 children (a back-face
    # hit's hemisphere faces the wall) and none of the grandchildren
    assert 0 < hit0 < n0 and alive1 == 2 * hit0 < n1
    assert 0 < hit1 < alive1 // 10 and alive2 == hit1 < n2
    assert 5 * (hit0 + hit1 + hit2) < n0 + n1 + n2
    target = rad.numpy() * np.float32(0.8)
    with torch.no_grad():
        assert torch.equal(rad, _port_render(p, W, H, recursions=2))
    pg_s, pg_c = _port_grads(p, W, H, target, 2, counting)
    bg_s, bg_c = _port_grads(p, W, H, target, 2)
    for obj, bobj, names in ((pg_s, bg_s, SCENE_LEAVES),
                             (pg_c, bg_c, CAMERA_LEAVES)):
        for name in names:
            assert bool(torch.isfinite(getattr(obj, name)).all()), name
            if name != "tri_verts":
                _assert_grads_close(getattr(obj, name), getattr(bobj, name),
                                    f"{kind} {name}")
    assert float(pg_s.tri_verts.abs().max()) > 0


def test_record_paths_refuse_autograd(boxes):
    """The winning-record paths have no gradient (their records are
    forward-only constants, as in the JAX package): a BVH query with
    emit_shade=True and trace_radiance with shade_records raise under
    autograd and run under no_grad."""
    p, _, buf = boxes
    isect = make_intersector("bvh", buf, device="cpu")
    scene = p["scene"]
    records = build_slot_records(scene, isect.perm, isect.perm.shape[0])
    isect.set_shade_records(records[:, :6])
    o = torch.zeros((4, 3), requires_grad=True)
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match="emit_shade"):
        isect.query(None, o, d, emit_shade=True)
    with torch.no_grad():
        assert isect.query(None, o, d, emit_shade=True)["rec"].shape == (4, 6)
    stream = [p["draws"]().next_sample(4)[1]]
    with pytest.raises(ValueError, match="shade_records"):
        trace_radiance(scene, o, d, stream, isect, 1, 1,
                       shade_records=records)
    with torch.no_grad():
        assert trace_radiance(scene, o, d, stream, isect, 1, 1,
                              shade_records=records).shape == (4, 3)
    assert trace_radiance(scene, o, d, stream, isect, 1, 1).requires_grad


@pytest.mark.parametrize("kind", KINDS)
def test_optimize_over_kernel_intersector_matches_jax(tri_scene, tri_render,
                                                      kind):
    """10 Adam steps of the albedo of the wall triangle over each accel:
    the port's optimize against the JAX optimize over its same accel, the
    losses within rtol 1e-3 (as test_inverse_rendering_recovers_albedo
    holds them) and falling."""
    p, j = tri_scene
    W, H = 16, 12
    jisect, pisect = _isects(_wall().to_buffers(), kind)
    start_p = dataclasses.replace(p["scene"], **params_from_numpy(
        {"mat_diffuse_rgb": np.full((1, 3), 0.5, np.float32)}, device="cpu"))
    _, losses = optimize(
        start_p, p["cam"], p["px"], p["py"], W, H, pisect,
        torch.from_numpy(np.array(tri_render)), fields=("mat_diffuse_rgb",),
        steps=10, learning_rate=5e-2, jitter=p["jitter"],
        draws=KeyDraws(j["key"], 0))
    start_j = dataclasses.replace(
        j["scene"], mat_diffuse_rgb=jnp.full_like(j["scene"].mat_diffuse_rgb,
                                                  0.5))
    _, jlosses = jax_optimize(start_j, j["cam"], j["px"], j["py"], W, H,
                              jisect, jnp.asarray(tri_render),
                              fields=("mat_diffuse_rgb",), steps=10,
                              learning_rate=5e-2, jitter=j["jitter"])
    assert losses[-1] < losses[0] * 0.5, losses
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)


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
