"""External-artifact validation on the port (tests/test_external_texture.py
on the port): the one binary artifact the reference repo ships that this
build did not generate, data/blender_cycles_ico3.png (a scribble texture
that ico3_tex.dae binds), through the port's whole texture chain:

  PNG bytes -> the port's loader (/256 quirk, texture.rs:34-50)
            -> scene flattening / atlas packing
            -> per-hit barycentric texel lookup in the render
               (mod.rs:244-247 + texture.rs:21-27)

Every step is recomputed with independent numpy on the raw PNG and must
equal the port's values exactly."""

import numpy as np
import pytest
import torch
from PIL import Image

from raytracer_tpu_torch.core.intersectors import BruteForceIntersector
from raytracer_tpu_torch.core.shade import sample_diffuse
from raytracer_tpu_torch.models.camera import generate_rays
from raytracer_tpu_torch.models.collada import ColladaLoader
from tests.test_torch_wavefront import torch_threads  # noqa: F401 (autouse)

W, H = 96, 96


@pytest.fixture(scope="module")
def scene(data_dir):
    return ColladaLoader.from_file(data_dir / "ico3_tex.dae",
                                   width=W, height=H, verbose=False)


@pytest.fixture(scope="module")
def png(data_dir):
    return np.asarray(Image.open(
        data_dir / "blender_cycles_ico3.png").convert("RGB"))


def test_texture_atlas_matches_external_png_bytes(scene, png):
    """Loaded atlas == raw PNG / 256 (texture.rs:44: u8 as f32 / 256.0),
    exactly."""
    buf = scene.to_buffers()
    th, tw = buf.tex_hw[0]
    assert (th, tw) == png.shape[:2]
    np.testing.assert_array_equal(buf.tex_atlas[0, :th, :tw],
                                  png.astype(np.float32) / 256.0)


def test_rendered_texels_match_independent_png_lookup(scene, png):
    """Trace primary rays through the pixel centres, take each textured
    hit's barycentric (u, v), and check the port's diffuse colour equals
    an independent nearest-neighbour lookup straight into the raw PNG
    (x = int(u*w), y = int(v*h); mod.rs:244-247)."""
    dev = scene.to_buffers().to_device("cpu")
    cam = scene.cameras[0].params("cpu")
    px = torch.arange(W, dtype=torch.int32).repeat(H)
    py = torch.arange(H, dtype=torch.int32).repeat_interleave(W)
    o, d = generate_rays(cam, px, py, torch.full((W * H, 2), 0.5), W, H)
    hit = BruteForceIntersector().query(dev, o, d)

    geom = dev.tri_geom.numpy()[hit["tri"].numpy()]
    tex_id = dev.mat_tex_id.numpy()[geom]
    sel = hit["hit"].numpy() & (tex_id >= 0)
    assert sel.sum() > 100, "expected many textured hits on ico3_tex"

    got = sample_diffuse(dev, hit["tri"], hit["u"], hit["v"]).numpy()[sel]
    th, tw = png.shape[:2]
    u = hit["u"].numpy()[sel]
    v = hit["v"].numpy()[sel]
    x = np.clip((u * tw).astype(np.int64), 0, tw - 1)
    y = np.clip((v * th).astype(np.int64), 0, th - 1)
    want = png[y, x].astype(np.float32) / 256.0
    np.testing.assert_array_equal(got, want)
    # the lookup exercises the external content: many distinct texels
    assert len(np.unique((want * 256).astype(np.uint8).reshape(-1, 3),
                         axis=0)) > 10
