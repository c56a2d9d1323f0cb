"""The PyTorch port's host scene side against the JAX package: COLLADA
loading into SceneBuffers, build_bvh2, camera ray generation and
the loader's error variants, on the same inputs."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.models.camera import generate_rays as jax_generate_rays
from raytracer_tpu.models.collada import (ColladaError as JaxColladaError,
                                          ColladaLoader as JaxLoader)
from raytracer_tpu.ops.bvh import build_bvh2 as jax_build_bvh2
from raytracer_tpu_torch.models.camera import generate_rays
from raytracer_tpu_torch.models.collada import Collada, ColladaError, ColladaLoader
from raytracer_tpu_torch.models.types import SceneArrays
from raytracer_tpu_torch.ops.bvh import build_bvh2
from tests import fixtures
from tests.test_torch_wavefront import torch_threads  # noqa: F401 (autouse)

SCENES = [("4boxes.dae", 48), ("ico2.dae", 608), ("ico3_tex.dae", 608),
          ("thai2.dae", 20049)]


@pytest.fixture(scope="module")
def thai2_tris(data_dir):
    return ColladaLoader.from_file(data_dir / "thai2.dae",
                                   verbose=False).to_buffers().tri_verts


@pytest.mark.parametrize("name,n_tris", SCENES)
def test_scene_buffers_equal_reference(data_dir, name, n_tris):
    got = ColladaLoader.from_file(data_dir / name, verbose=False).to_buffers()
    want = JaxLoader.from_file(data_dir / name, verbose=False).to_buffers()
    assert got.tri_verts.shape == (n_tris, 3, 3)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_scene_arrays_from_numpy(data_dir):
    buf = ColladaLoader.from_file(data_dir / "4boxes.dae",
                                  verbose=False).to_buffers()
    arrays = SceneArrays.from_numpy(buf, device="cpu")
    assert arrays.num_triangles == 48
    np.testing.assert_array_equal(arrays.tri_verts.numpy(), buf.tri_verts)
    assert arrays.tri_geom.dtype == torch.int32


@pytest.mark.parametrize("tpl", [128, 256])
def test_build_bvh2_equals_reference(thai2_tris, tpl):
    got = build_bvh2(thai2_tris, triangles_per_leaf=tpl, group=8, seg=4)
    want = jax_build_bvh2(thai2_tris, triangles_per_leaf=tpl, group=8, seg=4)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_generate_rays_within_one_ulp(data_dir):
    W, H = 40, 24
    got_scene = ColladaLoader.from_file(data_dir / "ico2.dae", width=W,
                                        height=H, verbose=False)
    want_scene = JaxLoader.from_file(data_dir / "ico2.dae", width=W,
                                     height=H, verbose=False)
    cam_t, cam_j = got_scene.cameras[0], want_scene.cameras[0]
    for cam in (cam_t, cam_j):
        cam.add_x_angle(0.3)
        cam.add_y_angle(-0.7)
        cam.move_rel(0.5, -0.25, 1.0)
    rng = np.random.default_rng(0)
    px = np.tile(np.arange(W, dtype=np.int32), H)
    py = np.repeat(np.arange(H, dtype=np.int32), W)
    jitter = rng.random((W * H, 2), dtype=np.float32)
    o, d = generate_rays(cam_t.params("cpu"), torch.from_numpy(px),
                         torch.from_numpy(py), torch.from_numpy(jitter), W, H)
    oj, dj = jax_generate_rays(cam_j.params(), jnp.asarray(px),
                               jnp.asarray(py), jnp.asarray(jitter), W, H)
    np.testing.assert_array_equal(o.numpy(), np.asarray(oj))
    np.testing.assert_array_max_ulp(d.numpy(), np.asarray(dj), maxulp=1)


def _bad_docs():
    good = fixtures.make_doc(positions=[0, 0, 0, 1, 0, 0, 0, 1, 0],
                             indices=[0, 1, 2])
    return {
        "ParseError": "<COLLADA><unclosed></COLLADA>",
        "NotColladaDoc": "<notcollada/>",
        "RemainingData": good.replace("<scene>", "<extra/><scene>"),
        "LibraryCamerasParsing": good.replace(
            "library_cameras", "library_cams"),
        "CamerasConversion": good.replace(
            '<xfov sid="xfov">39.59775</xfov>', '<xfov sid="xfov">x</xfov>'),
        "MaterialsConversion": good.replace(
            'url="#Material-effect"', ""),
        "VisualSceneConversion": good.replace(
            '<instance_camera url="#Camera-camera"/>', ""),
        "ElementError": good.replace("<mesh>", "<mush>").replace(
            "</mesh>", "</mush>"),
    }


@pytest.mark.parametrize("variant", sorted(_bad_docs()))
def test_collada_error_variants_match(variant):
    doc = _bad_docs()[variant]
    with pytest.raises(JaxColladaError) as want:
        JaxLoader.from_str(doc, verbose=False)
    with pytest.raises(ColladaError) as got:
        ColladaLoader.from_str(doc, verbose=False)
    assert want.value.variant == variant
    assert got.value.variant == want.value.variant
    assert str(got.value) == str(want.value)


def test_parse_synthetic_doc_matches_reference():
    doc = fixtures.make_doc(positions=[0, 0, 0, 1, 0, 0, 0, 1, 0],
                            indices=[0, 1, 2],
                            geom_matrix=fixtures.translate_matrix(1, 2, 3))
    got = ColladaLoader.from_str(doc, verbose=False).to_buffers()
    want = JaxLoader.from_str(doc, verbose=False).to_buffers()
    np.testing.assert_array_equal(got.tri_verts, want.tri_verts)
    assert len(Collada.parse(doc).nodes) == 3
