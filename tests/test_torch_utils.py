"""The port's utilities and small surfaces against the JAX package's:
stats and timing, PNG IO, the tonemaps and the film, the sample table,
the inline scene, the compat v-bug pair of tests/test_misc.py, the
native de-indexing gather (tests/test_native.py), and the live viewer on
a local port."""

import json
import time
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.core import tonemap as jtonemap
from raytracer_tpu.core.film import Film as JaxFilm
from raytracer_tpu.core.sampler import SampleGenerator as JaxSampleGenerator
from raytracer_tpu.inline_scene import INLINE_SCENE_DOC as JAX_DOC
from raytracer_tpu.utils.png_io import u32_to_rgba8 as jax_u32_to_rgba8
from raytracer_tpu_torch.core import tonemap
from raytracer_tpu_torch.core.film import Film
from raytracer_tpu_torch.core.sampler import (SampleGenerator,
                                              sample_hemisphere)
from raytracer_tpu_torch.inline_scene import (INLINE_SCENE_DOC,
                                              create_inline_raytracer)
from raytracer_tpu_torch.utils.png_io import (decode_png, encode_png,
                                              u32_to_rgba8, write_png)
from raytracer_tpu_torch.utils.stats import Stats
from raytracer_tpu_torch.utils.timing import BenchMark
from tests.test_torch_wavefront import TORCH_THREADS


def test_stats_meter():
    import raytracer_tpu_torch as rtx
    assert rtx.stats.Stats is Stats
    s = Stats()
    time.sleep(0.01)
    line = s.stats(1000)
    assert "fps" in line and "primary rays/s" in line
    assert "mean fps" in s.mean_stats()
    assert s.num_measurements == 1


def test_timing_benchmark():
    bm = BenchMark()
    bm.start("a")
    time.sleep(0.01)
    bm.stop("a")
    with bm.time_scope("b"):
        time.sleep(0.002)
    rows = bm.collect_timing_results()
    assert rows[0][0] == "a"  # sorted by total desc
    assert rows[0][2] >= rows[1][2]
    assert "a:" in bm.report()
    with pytest.raises(KeyError):
        bm.stop("never-started")


def test_profiling_trace_and_annotate(tmp_path):
    """trace(log_dir) writes a torch.profiler trace there; span() names a
    region that shows up in it."""
    import os
    from raytracer_tpu_torch.utils.profiling import span, trace
    with trace(str(tmp_path / "prof")) as prof:
        with span("render-frame"):
            torch.ones(64).cumsum(0)
    assert "render-frame" in {e.key for e in prof.key_averages()}
    path = tmp_path / "prof" / "trace.json"
    assert os.path.getsize(path) > 0 and b"render-frame" in path.read_bytes()


def test_png_roundtrip(tmp_path):
    """The stdlib encoder's bytes decode to the image (with PIL and with
    decode_png), and write_png's file reads back equal."""
    from PIL import Image
    img = np.random.default_rng(0).integers(0, 256, (8, 12, 3), np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    p = tmp_path / "enc.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    q = tmp_path / "x.png"
    write_png(q, img)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), img)
    with pytest.raises(ValueError):
        decode_png(b"GIF89a" + data[6:])


def test_u32_unpack():
    pix = np.array([0xFF112233, 0x80FFFFFF, 0], dtype=np.uint32)
    rgba = u32_to_rgba8(pix, 3, 1)
    np.testing.assert_array_equal(rgba[0, 0], [0x11, 0x22, 0x33, 0xFF])
    np.testing.assert_array_equal(rgba, jax_u32_to_rgba8(pix, 3, 1))


@pytest.mark.parametrize("name", ["to_xyz", "to_rgb", "luminance_simple_map",
                                  "gamma_map", "simple_map"])
def test_tonemaps_match_reference(name):
    rgb = np.random.default_rng(1).uniform(0, 4, (64, 3)).astype(np.float32)
    rgb[0] = (1.0, 1.0, 1.0)
    want = np.asarray(getattr(jtonemap, name)(jnp.asarray(rgb)))
    got = getattr(tonemap, name)(torch.from_numpy(rgb)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_tonemap_color_space_roundtrip():
    # tonemap.rs:53-70 parity test
    rgb = torch.tensor([[1.0, 1.0, 1.0]])
    np.testing.assert_allclose(tonemap.to_rgb(tonemap.to_xyz(rgb)).numpy(),
                               rgb.numpy(), atol=1e-5)


def test_film_full_frame_and_variance_match_reference():
    rng = np.random.default_rng(2)
    frames = [rng.uniform(0, 2, (6, 3)).astype(np.float32) for _ in range(3)]
    f, jf = Film(6, "cpu"), JaxFilm(6)
    for fr in frames:
        f.add_full_frame(torch.from_numpy(fr), 1.0)
        jf.add_full_frame(jnp.asarray(fr), 1.0)
    f.add_samples(torch.tensor([0, 0]), torch.ones((2, 3)))
    jf.add_samples(jnp.array([0, 0]), jnp.ones((2, 3)))
    for get in ("get_pixels", "get_estimated_variances"):
        np.testing.assert_allclose(getattr(f, get)().numpy(),
                                   np.asarray(getattr(jf, get)()), rtol=1e-6)
    assert f.num_samples.tolist() == [5.0] + [3.0] * 5


def test_film_variance_hook():
    f = Film(4, "cpu")
    idx = torch.tensor([0])
    for v in (1.0, 2.0, 3.0):
        f.add_samples(idx, torch.full((1, 3), v))
    var = f.get_estimated_variances().numpy()[0]
    np.testing.assert_allclose(var, 50.0 / 3.0, rtol=1e-4)


def test_sample_generator_matches_reference():
    """The same seed gives the same 65,536-vector table and lookups."""
    a, b = SampleGenerator(3), JaxSampleGenerator(3)
    np.testing.assert_array_equal(a.normalized_vecs, b.normalized_vecs)
    np.testing.assert_allclose(np.linalg.norm(a.normalized_vecs, axis=-1),
                               1.0, rtol=1e-6)
    for _ in range(3):
        np.testing.assert_array_equal(a.normalized_vec_lookup(),
                                      b.normalized_vec_lookup())
    np.testing.assert_array_equal(
        a.normalized_vec_pseudo(np.random.default_rng(4)),
        b.normalized_vec_pseudo(np.random.default_rng(4)))


def test_sample_hemisphere():
    g = torch.Generator().manual_seed(0)
    n = torch.nn.functional.normalize(torch.randn((500, 3), generator=g),
                                      dim=1)
    d = sample_hemisphere(torch.Generator().manual_seed(1), n)
    assert torch.allclose(d.norm(dim=1), torch.ones(500), atol=1e-6)
    assert bool(((d * n).sum(1) >= 0).all())


def test_inline_scene_doc_equals_reference_and_renders():
    assert INLINE_SCENE_DOC == JAX_DOC
    rt = create_inline_raytracer(width=32, height=24, accel="brute",
                                 device="cpu")
    img = rt.render_image(spp=1)
    assert (img.max(axis=-1) > 0).mean() > 0.5  # octahedron + backdrop


def test_compat_v_bug_changes_rays(data_dir):
    """mod.rs:96 — with width != height the reference's v = idx/height
    scrambles ray rows; the compat flag must give another image than
    the corrected mapping."""
    from raytracer_tpu_torch import create_raytracer_from_file
    kw = dict(width=32, height=24, accel="brute", seed=7, device="cpu")
    a = create_raytracer_from_file(str(data_dir / "4boxes.dae"),
                                   **kw).render(spp=1)
    b = create_raytracer_from_file(str(data_dir / "4boxes.dae"),
                                   compat_v_bug=True, **kw).render(spp=1)
    assert not np.allclose(a, b)


def test_compat_v_bug_noop_on_square(data_dir):
    from raytracer_tpu_torch import create_raytracer_from_file
    kw = dict(width=16, height=16, accel="brute", seed=7, device="cpu")
    a = create_raytracer_from_file(str(data_dir / "4boxes.dae"),
                                   **kw).render(1)
    b = create_raytracer_from_file(str(data_dir / "4boxes.dae"),
                                   compat_v_bug=True, **kw).render(1)
    np.testing.assert_allclose(a, b)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _wait(cond, what, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.02)


def test_viewer_serves_frames_stats_and_keys():
    """The viewer on a free local port, server and render loop in
    threads, on the CPU: the page, a decodable frame, the stats, a key
    that rotates the camera and clears the film, then a clean close."""
    from raytracer_tpu_torch.viewer import Viewer
    rt = create_inline_raytracer(width=24, height=16, accel="brute",
                                 device="cpu", rows_per_frame=8)
    viewer = Viewer(rt, port=0).start(serve=True)
    try:
        assert viewer.port > 0
        _wait(lambda: viewer.state["frames"] >= 3 or viewer.error,
              "3 frames")
        assert viewer.error is None, viewer.error
        status, ctype, body = _get(viewer.port, "/")
        assert status == 200 and b"/frame.png" in body
        status, ctype, body = _get(viewer.port, "/frame.png")
        assert ctype == "image/png"
        img = decode_png(body)
        assert img.shape == (16, 24, 3) and img.max() > 0
        stats = json.loads(_get(viewer.port, "/stats")[2])
        assert stats["frames"] >= 3 and stats["rays_per_sec"] > 0
        # the program's counters: 2 cursor positions, frames read back
        counters = stats["counters"]
        assert counters["row_block_builds"] >= 2
        assert counters["readback_bytes"] >= 3 * 16 * 24 * 3
        assert "launches.bvh_spawn" in counters
        assert _get(viewer.port, "/key/w")[2] == b"ok"
        _wait(lambda: rt.camera.x_angle_radians != 0.0, "the key")
    finally:
        viewer.close()
    assert viewer.error is None, viewer.error
    assert rt.camera.x_angle_radians == pytest.approx(0.1)
    # the key cleared the film after frame k >= 3: only the frames since
    # then are on it (each adds rows_per_frame * width samples)
    frames = viewer.state["frames"]
    assert float(rt.film.num_samples.sum()) <= (frames - 3) * 8 * 24
    assert not viewer._render.is_alive() and not viewer._http.is_alive()


def test_native_deindex_matches_reference():
    """native.deindex (the rtx_deindex binding of csrc/rtx_native.cpp)
    against verts[idx] and the JAX package's binding of the same source,
    on tests/test_native.py's case and on a random soup."""
    from raytracer_tpu import native as jax_native
    from raytracer_tpu_torch import native
    verts = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([2, 0, 3, 1, 1, 2], dtype=np.int64)
    np.testing.assert_array_equal(native.deindex(verts, idx), verts[idx])
    rng = np.random.default_rng(6)
    verts = rng.normal(size=(500, 3)).astype(np.float32)
    idx = rng.integers(0, 500, size=3000)
    got = native.deindex(verts, idx)
    assert got.dtype == np.float32 and got.shape == (3000, 3)
    np.testing.assert_array_equal(got, verts[idx])
    np.testing.assert_array_equal(got, jax_native.deindex(verts, idx))


def test_torch_threads_hold_the_suite_budget():
    """Importing test_torch_wavefront sets one torch thread budget per
    worker before any test runs; a test file that resets it would run
    every later file of its worker on another count."""
    assert torch.get_num_threads() == TORCH_THREADS
    assert torch.get_num_interop_threads() == TORCH_THREADS
