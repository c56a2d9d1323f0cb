"""The port's fused wavefront (core/wavefront.py) against the JAX
package's trace_radiance_fused with its Pallas kernels in interpret
mode: same scene, same BVH arrays, same primary rays, and the same
threefry draws (replayed through the adapter below)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu import create_raytracer_from_file as jax_create
from raytracer_tpu.core.shade import build_slot_records as jax_slot_records
from raytracer_tpu.core.wavefront import _sort_key as jax_sort_key
from raytracer_tpu.core.wavefront import trace_radiance_fused as jax_fused
from raytracer_tpu.models.camera import generate_rays as jax_generate_rays
from raytracer_tpu.ops.pallas_bvh import BVHIntersector as JaxBVH
from raytracer_tpu_torch.core.wavefront import trace_radiance_fused
from raytracer_tpu_torch.models.types import SceneArrays
from raytracer_tpu_torch.ops import cuda_bvh
from raytracer_tpu_torch.ops.cuda_bvh import BVHIntersector


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """At most 2 torch CPU threads while a module's tests run (the port's
    test files import this fixture).  The suite runs several pytest
    workers at once, and torch's default of a thread per core then
    oversubscribes the CPU; the port's test shapes are small, so its ops
    gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class ThreefryStream:
    """One sample's Gaussian stream, replaying the JAX engine's draws:
    subs = split(kt, recursions); level l draws normal(subs[l], (n, 3))
    (wavefront.py:352-360)."""

    def __init__(self, kt, recursions):
        self.subs = jax.random.split(kt, recursions) if recursions else None

    def normal(self, level, n):
        return torch.from_numpy(np.array(jax.random.normal(
            self.subs[level], (n, 3), dtype=jnp.float32)))


class ThreefryDraws:
    """The JAX engine's per-sample key chain (engine.py:169-171,
    :269-279, :304-322): key, k = split(key); kj, kt = split(k); jitter
    = uniform(kj, (n, 2)); Gaussians from kt.  `split(n)` replays the
    per-device keys of render_sharded: the frame key from the chain
    (`_next_key()`, engine.py:169-171), then split(frame_key, n)
    (`_per_device_keys`, parallel/render.py:33-37), each rank's key
    chained per sample as above (render.py:104-120)."""

    def __init__(self, seed, recursions, key=None):
        self.key = jax.random.PRNGKey(seed) if key is None else key
        self.recursions = recursions

    def next_sample(self, n):
        self.key, k = jax.random.split(self.key)
        kj, kt = jax.random.split(k)
        jitter = jax.random.uniform(kj, (n, 2), dtype=jnp.float32)
        return (torch.from_numpy(np.array(jitter)),
                ThreefryStream(kt, self.recursions))

    def split(self, n):
        self.key, frame_key = jax.random.split(self.key)
        return [ThreefryDraws(None, self.recursions, key=k)
                for k in jax.random.split(frame_key, n)]


def _setup(data_dir, scene="4boxes.dae", W=32, H=16):
    rt = jax_create(str(data_dir / scene), width=W, height=H, accel="brute")
    sb = rt.scene_buffers
    key = jax.random.PRNGKey(7)
    kj, kt = jax.random.split(key)
    px = jnp.asarray(np.tile(np.arange(W, dtype=np.int32), H))
    py = jnp.asarray(np.repeat(np.arange(H, dtype=np.int32), W))
    jitter = jax.random.uniform(kj, (W * H, 2), dtype=jnp.float32)
    o, d = jax_generate_rays(rt.camera.params(), px, py, jitter, W, H)

    ref = JaxBVH(sb, triangles_per_leaf=128, use_pallas=True)
    has_tex = bool((sb.mat_tex_id >= 0).any())
    records = np.array(jax_slot_records(rt.scene_arrays, ref.perm,
                                        ref.perm.shape[0]))
    records = records[:, :7 if has_tex else 6]
    ref.set_shade_records(jnp.asarray(records))
    b = ref.bvh
    port = BVHIntersector.from_bvh_arrays(
        b.perm, b.v0, b.e1, b.e2, b.leaf_aabb, b.seg_aabb, b.sc_aabb,
        b.orders, group=8, device="cpu")
    port.set_shade_records(torch.from_numpy(records))
    return dict(jscene=rt.scene_arrays, sb=sb, o=o, d=d, kt=kt, ref=ref,
                port=port)


def _port_scene(sb, **replace):
    fields = {f.name: getattr(sb, f.name) for f in dataclasses.fields(sb)}
    fields.update(replace)
    return SceneArrays.from_numpy(fields, device="cpu")


def _port(s, scene=None, recursions=2, kt=None, **kw):
    o = torch.from_numpy(np.array(s["o"]))
    d = torch.from_numpy(np.array(s["d"]))
    streams = [ThreefryStream(s["kt"] if kt is None else kt, recursions)]
    rad = trace_radiance_fused(scene or _port_scene(s["sb"]), o, d, streams,
                               s["port"], recursions=recursions, spread=1,
                               **kw)
    return rad.numpy()


def _assert_flip_bound(got, want):
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
    # the repo's rule: bound the COUNT of edge-flipped values
    # (tests/test_fused_spawn.py:56-62)
    assert (~close).sum() <= 24, f"{(~close).sum()} of {close.size} mismatch"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=5e-3)


@pytest.fixture(scope="module")
def boxes(data_dir):
    return _setup(data_dir)


def test_direct_lighting_matches_reference(boxes):
    """recursions=0: no Monte-Carlo children, deterministic radiance."""
    s = boxes
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused(s["jscene"], s["o"], s["d"], s["kt"],
                                    s["ref"], recursions=0, spread=1))
    got = _port(s, recursions=0)
    assert got.shape == want.shape == (512, 3)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_two_bounces_two_lights_match_reference(boxes):
    """recursions=2 (the reference fan-out, both bounce sorts) with a
    second synthetic light (light-major shadow batch, per-chunk light
    colour, chunk sum)."""
    s = boxes
    sb = s["sb"]
    lp2 = np.concatenate([sb.light_pos,
                          sb.light_pos * np.array([[-1.0, 1.0, 1.0]], np.float32)])
    lc2 = np.concatenate([sb.light_color, sb.light_color * np.float32(0.35)])
    jscene = dataclasses.replace(s["jscene"], light_pos=jnp.asarray(lp2),
                                 light_color=jnp.asarray(lc2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused(jscene, s["o"], s["d"], s["kt"],
                                    s["ref"], recursions=2, spread=1))
    got = _port(s, scene=_port_scene(sb, light_pos=lp2, light_color=lc2))
    _assert_flip_bound(got, want)


def test_textured_direct_lighting_matches_reference(data_dir):
    """ico3_tex: the spawn emits u/v and the glue fetches texels."""
    s = _setup(data_dir, "ico3_tex.dae", W=24, H=16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused(s["jscene"], s["o"], s["d"], s["kt"],
                                    s["ref"], recursions=0, spread=1))
    got = _port(s, recursions=0)
    _assert_flip_bound(got, want)


@pytest.fixture(scope="module")
def boxes_radiance(boxes):
    """The port's two-bounce radiance of the boxes' rays (pool 1, dir6
    keys, "ride"), computed once for the tests that compare against it."""
    return _port(boxes)


def test_pooled_matches_per_sample_bit_for_bit(boxes, boxes_radiance):
    """pool=2: both samples' bounce rays share one sort; per-sample
    radiance must equal the two pool=1 calls exactly."""
    s = boxes
    k2 = jax.random.fold_in(s["kt"], 1)
    want0 = boxes_radiance
    want1 = _port(s, kt=k2)
    o = torch.from_numpy(np.array(s["o"]))
    d = torch.from_numpy(np.array(s["d"]))
    got = trace_radiance_fused(
        _port_scene(s["sb"]), torch.cat([o, o]), torch.cat([d, d]),
        [ThreefryStream(s["kt"], 2), ThreefryStream(k2, 2)], s["port"],
        recursions=2, spread=1, pool=2).numpy()
    np.testing.assert_array_equal(got[:512], want0)
    np.testing.assert_array_equal(got[512:], want1)


def test_sort_payload_and_key_modes_are_result_invariant(boxes,
                                                        boxes_radiance):
    """"ride" and "gather" run the same stable sort (bit-equal), and the
    sort key only reorders rays: every key mode gives the same bits."""
    s = boxes
    want = boxes_radiance
    np.testing.assert_array_equal(_port(s, sort_payload="gather"), want)
    for mode in ("dir9", "dirmajor", "posmajor"):
        np.testing.assert_array_equal(_port(s, sort_key_mode=mode), want)
    with pytest.raises(ValueError):
        _port(s, sort_payload="scatter")


@pytest.mark.parametrize("mode", ["dir6", "dir9", "dirmajor", "posmajor"])
def test_sort_key_matches_reference(boxes, mode):
    rng = np.random.default_rng(3)
    o = rng.uniform(-6, 6, size=(2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d[:64, 1:] = 0.0
    alive = rng.random(2048) > 0.2
    ref = boxes["ref"]
    want = np.asarray(jax_sort_key(ref, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(alive), mode=mode))
    port = boxes["port"]
    got = cuda_bvh.sort_key(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(alive), port.world_lo,
                            port.world_inv_span, mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[alive] < 2 ** 30).all() and (got[~alive] == 2 ** 30).all()
