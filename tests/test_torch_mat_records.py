"""The compact "mat" shading records on the port's fused wavefront: the
spawn kernel extracts [normal, material id] and the glue gathers the
diffuse rgb (and tex id) from the per-material tables.  Held against
the JAX package's trace_radiance_fused over its BVHIntersector with the
same "mat" records (Pallas in interpret mode), and against the port's
own "full" records, which must give the same radiance value for value."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.core.wavefront import trace_radiance_fused as jax_fused
from raytracer_tpu_torch.core.shade import build_slot_records
from raytracer_tpu_torch.ops.cuda_bvh import BVHIntersector
from tests.test_torch_wavefront import _port, _port_scene, _setup

MAT_COLS = [0, 1, 2, 7]       # normal xyz, geometry (= material) id


def _assert_flip_bound(got, want):
    """The repo's rule (tests/test_fused_spawn.py:56-62): at most 24
    values beyond rtol 2e-4.  One flipped bounce changes its pixel
    outright, so on a few hundred pixels the channel means are no
    tighter test than the count (tests/test_torch_engine.py)."""
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert (~close).sum() <= 24, f"{(~close).sum()} of {close.size} mismatch"


def _records(s):
    """The port's (S, 8) slot records of the setup's BVH."""
    scene = _port_scene(s["sb"])
    return build_slot_records(scene, s["port"].perm, s["port"].perm.shape[0])


def _textured(s):
    return bool((s["sb"].mat_tex_id >= 0).any())


def _use(s, fmt):
    """Install `fmt` records on both the JAX and the port intersector."""
    rec = _records(s)
    tex = _textured(s)
    if fmt == "mat":
        s["port"].set_shade_records(rec[:, MAT_COLS], fmt="mat", textured=tex)
        s["ref"].set_shade_records(jnp.asarray(rec[:, MAT_COLS].numpy()),
                                   fmt="mat", textured=tex)
    else:
        full = rec[:, :7 if tex else 6]
        s["port"].set_shade_records(full)
        s["ref"].set_shade_records(jnp.asarray(full.numpy()))


@pytest.fixture(scope="module")
def scenes(data_dir):
    return {"4boxes": _setup(data_dir),
            "ico3_tex": _setup(data_dir, "ico3_tex.dae", W=24, H=16)}


@pytest.mark.parametrize("name,recursions", [("4boxes", 1),
                                             ("ico3_tex", 0),
                                             ("ico3_tex", 1)])
def test_mat_records_match_reference(scenes, name, recursions):
    """The port's "mat" fused wavefront against the JAX one with "mat"
    records and the same threefry draws, under the flip rule (at most 24
    values beyond rtol 2e-4, tests/test_fused_spawn.py:56-62), up to one
    bounce.  Two bounces are held there through "full" records
    (tests/test_torch_wavefront.py), which "mat" equals exactly (below).
    On the textured sphere the JAX package's own fused and brute-force
    wavefronts already reach the rule's limit at two bounces (edge flips
    of bounce rays), so the rule leaves no room there."""
    s = scenes[name]
    _use(s, "mat")
    assert s["port"].fused_has_textures == _textured(s)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused(s["jscene"], s["o"], s["d"], s["kt"],
                                    s["ref"], recursions=recursions,
                                    spread=1))
    got = _port(s, recursions=recursions)
    assert got.shape == want.shape and want.max() > 0
    _assert_flip_bound(got, want)


@pytest.mark.parametrize("name", ["4boxes", "ico3_tex"])
def test_mat_records_equal_full_records(scenes, name):
    """"mat" and "full" read the same float32 table entries, so the port
    renders the same radiance, value for value, with the same draws."""
    s = scenes[name]
    _use(s, "full")
    full = _port(s)
    _use(s, "mat")
    mat = _port(s)
    assert full.max() > 0
    np.testing.assert_array_equal(mat, full)


def test_mat_records_need_textured(scenes):
    """A 4-column record cannot say whether the scene has textures, so
    fmt="mat" without textured= raises instead of rendering a textured
    scene flat; malformed records and formats raise too."""
    isect = scenes["ico3_tex"]["port"]
    rec = _records(scenes["ico3_tex"])
    with pytest.raises(ValueError, match="textured"):
        isect.set_shade_records(rec[:, MAT_COLS], fmt="mat")
    with pytest.raises(ValueError):
        isect.set_shade_records(rec[:, :6], fmt="mat", textured=True)
    with pytest.raises(ValueError):
        isect.set_shade_records(rec[:, MAT_COLS], fmt="full")
    with pytest.raises(ValueError):
        isect.set_shade_records(rec[:, :6], fmt="packed")


@pytest.mark.parametrize("fmt,cols,textured,spawn,shade,tex", [
    ("full", 6, None, True, True, False),
    ("full", 7, None, True, True, True),
    ("mat", 4, False, True, False, False),
    ("mat", 4, True, True, False, True),
])
def test_record_format_properties(data_dir, fmt, cols, textured, spawn,
                                  shade, tex):
    """supports_fused_spawn, supports_fused_shade and fused_has_textures
    per format (pallas_bvh.py:586-615); the kernel's own record
    extraction of the composable path takes "full" records only."""
    from raytracer_tpu_torch.models.collada import ColladaLoader
    sb = ColladaLoader.from_file(data_dir / "4boxes.dae",
                                 verbose=False).to_buffers()
    isect = BVHIntersector(sb, device="cpu")
    assert not (isect.supports_fused_spawn or isect.supports_fused_shade
                or isect.fused_has_textures)
    rec = build_slot_records(sb.to_device("cpu"), isect.perm,
                             isect.perm.shape[0])
    rec = rec[:, MAT_COLS] if fmt == "mat" else rec[:, :cols]
    isect.set_shade_records(rec, fmt=fmt, textured=textured)
    assert isect.rec_format == fmt and isect.shade_planes.shape[0] == cols
    assert (isect.supports_fused_spawn, isect.supports_fused_shade,
            isect.fused_has_textures) == (spawn, shade, tex)


def test_mat_engine_render_equals_full(data_dir):
    """Through the engine: a RayTracer whose BVH gets "mat" records after
    construction stays on the fused path and renders render(2) (pooled)
    equal to the "full" one."""
    from raytracer_tpu_torch import create_raytracer_from_file
    from tests.test_torch_wavefront import ThreefryDraws
    imgs = []
    for fmt in ("full", "mat"):
        rt = create_raytracer_from_file(
            str(data_dir / "ico3_tex.dae"), width=16, height=16,
            device="cpu", triangles_per_leaf=128,
            draws=ThreefryDraws(5, 2))
        if fmt == "mat":
            rec = build_slot_records(rt.scene_arrays, rt.intersector.perm,
                                     rt.intersector.perm.shape[0])
            rt.intersector.set_shade_records(rec[:, MAT_COLS], fmt="mat",
                                             textured=True)
        assert rt.fused and rt.intersector.fused_has_textures
        imgs.append(rt.render(2))
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0
    np.testing.assert_array_equal(imgs[1], imgs[0])


@pytest.mark.parametrize("fmt", ["full", "mat"])
def test_kernel_operands_are_contiguous(scenes, monkeypatch, fmt):
    """On the card the kernels take contiguous operands only (and raise
    otherwise); on the CPU the plain versions take any layout.  Every
    operand the fused wavefront hands the spawn and shadow-shade
    wrappers is contiguous, for both record formats on the textured
    scene (the texel fetch and the table gather make new planes)."""
    from raytracer_tpu_torch.ops import cuda_bvh
    seen = []

    def checked(fn):
        def wrapper(*args, **kw):
            for a in (*args, *kw.values()):
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), (fn.__name__, a.shape,
                                               a.stride())
                    seen.append(fn.__name__)
            return fn(*args, **kw)
        return wrapper

    for name in ("bvh_spawn", "bvh_shadow_shade"):
        monkeypatch.setattr(cuda_bvh, name, checked(getattr(cuda_bvh, name)))
    s = scenes["ico3_tex"]
    _use(s, fmt)
    _port(s, recursions=1)
    assert {"bvh_spawn", "bvh_shadow_shade"} <= set(seen)
