"""The RayTracer engine: progressive additive rendering and batch
rendering over the wavefront (PyTorch port of
``raytracer_tpu/core/engine.py``).

Capability parity with the reference render loop (reference:
raytracer_lib/src/raytracer/mod.rs:32-129):

- `trace_frame_additive()` renders `rows_per_frame` (default 50,
  mod.rs:87) rows, one jittered sample per pixel, additively into the
  film, advancing a progressive row cursor with wraparound
  (mod.rs:80-117), and returns the number of primary rays traced.
- `get_tonemapped_pixels()` = film mean -> Reinhard -> packed u32
  (mod.rs:120-129).
- Camera motion helpers clear the film (raytracer/src/main.rs:123-163).
- `render(spp)` is the batch API: whole frames, `pool` samples per
  wavefront, rays in 16x8 pixel tiles.

The accelerator is `accel` ("bvh", "cluster" or "brute") or a ready
`intersector=`.  An intersector with the fused kernels (the BVH, once
its shading records are installed here) runs `trace_radiance_fused`
with 8 samples pooled per wavefront; any other runs the composable
`trace_radiance`, one sample per wavefront, with the packed slot
records when the intersector has a slot layout (`perm`).

Known reference bug, reproduced only behind `compat_v_bug=True`: the
reference computes the pixel row for ray generation as `idx / height`
instead of `idx / width` (mod.rs:96).

Random numbers come from a draw source: `next_sample(n)` returns the
(n, 2) pixel jitter of one sample and that sample's own Gaussian stream
(`normal(level, n) -> (n, 3)`), and `split(n)` returns `n` independent
sources (one per rank of `render_sharded`).  The default `TorchDraws`
gives every sample a stream of its own, so a sample's numbers do not
depend on how many samples share its wavefront (the reference's key per
sample, engine.py:240-244, :269-279).  Public return types are numpy, as
in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.core.film import Film
from raytracer_tpu_torch.core.intersectors import make_intersector
from raytracer_tpu_torch.core.shade import build_slot_records
from raytracer_tpu_torch.core.tonemap import pack_u32, simple_map
from raytracer_tpu_torch.core.wavefront import (RECURSIONS, SORT_KEY_MODES,
                                                SORT_PAYLOADS, SUB_SPREAD,
                                                trace_radiance,
                                                trace_radiance_fused)
from raytracer_tpu_torch.models.camera import generate_rays
from raytracer_tpu_torch.models.types import resolve_device
from raytracer_tpu_torch.parallel.mesh import all_gather_rays, make_mesh
from raytracer_tpu_torch.parallel.render import (make_sharded_frame_loop,
                                                 pixel_grid)

# reference: oct_tree_intersector.rs:12
DEFAULT_TRIANGLES_PER_LEAF = 70

# samples pooled per wavefront on the fused path (the reference's
# measured default, engine.py:326-338)
DEFAULT_POOL = 8


_SEED_LIMIT = 2 ** 63 - 1


class TorchStream:
    """One sample's draws: its pixel jitter and each level's Gaussians,
    every one from a `torch.Generator` of its own on `device`, seeded
    from the k-th number of a host generator seeded from `seed` (k = 0
    for the jitter, 1 + level for a level), as the reference splits a
    sample's key once per level (wavefront.py:352-360).  So the numbers
    do not depend on the order in which they are asked for."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._host = torch.Generator()
        self._host.manual_seed(seed)
        self._seeds = []

    def _generator(self, k: int):
        while len(self._seeds) <= k:
            self._seeds.append(_draw_seed(self._host))
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seeds[k])
        return g

    def jitter(self, n: int):
        return torch.rand((n, 2), generator=self._generator(0),
                          device=self.device)

    def normal(self, level: int, n: int):
        return torch.randn((n, 3), generator=self._generator(1 + level),
                           device=self.device)


def _draw_seed(host) -> int:
    return int(torch.randint(0, _SEED_LIMIT, (1,), generator=host,
                             dtype=torch.int64))


class TorchDraws:
    """The product draw source: a host `torch.Generator` seeded from
    `seed` draws one 63-bit seed per sample, and the sample draws its
    jitter and Gaussians from a `TorchStream` of that seed on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._host = torch.Generator()
        self._host.manual_seed(seed)

    def next_sample(self, n: int):
        stream = TorchStream(_draw_seed(self._host), self.device)
        return stream.jitter(n), stream

    def split(self, n: int):
        """`n` independent sources: one frame source taken from this one
        (the reference's `_next_key()`, engine.py:169-171), then `n`
        taken from the frame source (`jax.random.split(key, n)`,
        parallel/render.py:33-37)."""
        frame = TorchDraws(_draw_seed(self._host), self.device)
        return [TorchDraws(_draw_seed(frame._host), self.device)
                for _ in range(n)]


class RayTracer:
    def __init__(self, scene, width: int, height: int,
                 intersector=None,
                 triangles_per_leaf: int = DEFAULT_TRIANGLES_PER_LEAF,
                 accel: str = "bvh",
                 recursions: int = RECURSIONS, spread: int = SUB_SPREAD,
                 rows_per_frame: int = 50,
                 compat_v_bug: bool = False,
                 sort_key_mode: str = "dir6",
                 accel_opts: dict | None = None,
                 spp_pool: int | None = None,
                 sort_payload: str = "ride",
                 seed: int = 0,
                 device=None,
                 draws=None):
        if sort_key_mode not in SORT_KEY_MODES:
            raise ValueError(f"unknown sort_key_mode {sort_key_mode!r}")
        if sort_payload not in SORT_PAYLOADS:
            raise ValueError(f"unknown sort_payload {sort_payload!r}")
        if not scene.cameras:
            raise ValueError("scene has no camera (reference uses scene.cameras[0], lib.rs:36)")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.scene = scene
        self.scene_buffers = scene.to_buffers()
        self.scene_arrays = self.scene_buffers.to_device(self.device)
        self.camera = scene.cameras[0]
        self.film = Film(width * height, self.device)
        self.current_row = 0
        self.rows_per_frame = rows_per_frame
        self.recursions = recursions
        self.spread = spread
        self.compat_v_bug = compat_v_bug
        self.sort_key_mode = sort_key_mode
        self.sort_payload = sort_payload
        self.spp_pool = spp_pool
        if intersector is None:
            opts = dict(accel_opts or {})
            if accel != "brute":
                opts["device"] = self.device
            intersector = make_intersector(
                accel, self.scene_buffers,
                triangles_per_leaf=triangles_per_leaf, **opts)
        self.intersector = intersector
        self._shade_args = self._shade_fast_args()
        self.draws = draws if draws is not None else TorchDraws(seed,
                                                                self.device)
        self._row_block_cache = {}
        self._frame_pixels = None
        self._sharded_key = self._sharded_frame = None

    @classmethod
    def from_scene(cls, scene, width, height, **kwargs):
        """reference: build_raytracer (lib.rs:29-44)"""
        return cls(scene, width, height, **kwargs)

    def _shade_fast_args(self):
        """Forward-only shading inputs (engine.py:108-133): the packed
        slot records, whether the scene has textures, and whether the
        intersector extracts records in its kernel.  Intersectors with a
        slot layout (`perm`) get the records, installed into the ones
        that take them (full format: normal xyz + diffuse rgb (+ tex
        id)); brute force reads the live scene arrays instead."""
        isect = self.intersector
        if getattr(isect, "perm", None) is None:
            return None, True, False
        has_tex = bool((self.scene_buffers.mat_tex_id >= 0).any())
        records = build_slot_records(self.scene_arrays, isect.perm,
                                     isect.perm.shape[0])
        if hasattr(isect, "set_shade_records"):
            isect.set_shade_records(records[:, :7 if has_tex else 6])
        fused = bool(getattr(isect, "supports_fused_shade", False))
        return records, has_tex, fused

    @property
    def fused(self) -> bool:
        """True when the render runs the fused wavefront kernels."""
        return bool(getattr(self.intersector, "supports_fused_spawn", False))

    def _radiance(self, origins, dirs, streams, pool):
        """Radiance of one wavefront: the fused kernels when the
        intersector has them (engine.py:135-155), the composable
        wavefront otherwise."""
        if self.fused:
            return trace_radiance_fused(
                self.scene_arrays, origins, dirs, streams, self.intersector,
                self.recursions, self.spread,
                sort_key_mode=self.sort_key_mode, pool=pool,
                sort_payload=self.sort_payload)
        records, has_tex, fused_shade = self._shade_args
        return trace_radiance(
            self.scene_arrays, origins, dirs, streams, self.intersector,
            self.recursions, self.spread, shade_records=records,
            has_textures=has_tex, fused_shade=fused_shade,
            sort_key_mode=self.sort_key_mode)

    # Spatial tile size for ray ordering: rays that share a kernel block
    # come from a compact 16x8 pixel tile, so culling acts on coherent
    # bundles instead of scanline strips.
    TILE_W, TILE_H = 16, 8

    def _row_block(self):
        """Pixel coordinates for the next `rows_per_frame` rows,
        tile-swizzled.  Cached per cursor position."""
        cached = self._row_block_cache.get(self.current_row)
        if cached is not None:
            return cached
        rows = (self.current_row + np.arange(self.rows_per_frame)) % self.height
        px = np.tile(np.arange(self.width, dtype=np.int32), self.rows_per_frame)
        py_actual = np.repeat(rows.astype(np.int32), self.width)
        order = np.lexsort((px % self.TILE_W, py_actual % self.TILE_H,
                            px // self.TILE_W, py_actual // self.TILE_H))
        px, py_actual = px[order], py_actual[order]
        idx = py_actual * self.width + px
        if self.compat_v_bug:
            # mod.rs:96 — v = idx / height with idx = row*width + i
            py_ray = (idx // self.height).astype(np.int32)
        else:
            py_ray = py_actual
        out = tuple(torch.from_numpy(a).to(self.device)
                    for a in (px, py_ray, idx.astype(np.int64)))
        self._row_block_cache[self.current_row] = out
        return out

    # -- reference API ----------------------------------------------------

    def trace_frame_additive(self) -> int:
        """One progressive frame: rows_per_frame rows, 1 spp, additive
        (mod.rs:80-117).  Returns num primary rays (= rows * width)."""
        px, py, idx = self._row_block()
        jitter, stream = self.draws.next_sample(px.shape[0])
        o, d = generate_rays(self.camera.params(self.device), px, py,
                             jitter.to(self.device), self.width, self.height)
        radiance = self._radiance(o, d, [stream], 1)
        self.film.add_samples(idx, radiance)
        self.current_row = (self.current_row + self.rows_per_frame) % self.height
        return self.rows_per_frame * self.width

    def get_tonemapped_pixels(self) -> np.ndarray:
        """Film mean -> Reinhard -> 0xAARRGGBB u32 (mod.rs:120-129)."""
        hdr = self.film.get_pixels()
        return pack_u32(simple_map(hdr)).cpu().numpy().astype(np.uint32)

    # -- camera controls (main.rs:123-163: every move clears the film) ----

    def move_camera(self, x: float, y: float, z: float):
        self.camera.move_rel(x, y, z)
        self.film.clear()

    def rotate_camera(self, x_radians: float = 0.0, y_radians: float = 0.0):
        if x_radians:
            self.camera.add_x_angle(x_radians)
        if y_radians:
            self.camera.add_y_angle(y_radians)
        self.film.clear()

    # -- batch-mode API (no reference equivalent) -------------------------

    def _pixels(self):
        """Tile-swizzled pixel coordinates of the whole (tile-padded)
        frame; the radiance un-swizzles by a reshape/permute."""
        if self._frame_pixels is None:
            W, H, TW, TH = self.width, self.height, self.TILE_W, self.TILE_H
            Wp, Hp = -(-W // TW) * TW, -(-H // TH) * TH
            ys, xs = np.meshgrid(np.arange(Hp, dtype=np.int32),
                                 np.arange(Wp, dtype=np.int32), indexing="ij")

            def swz(a):
                return (a.reshape(Hp // TH, TH, Wp // TW, TW)
                        .transpose(0, 2, 1, 3).reshape(-1))
            px = swz(xs)
            py = swz(ys)
            if self.compat_v_bug:
                py = ((py * W + px) // H).astype(np.int32)  # mod.rs:96
            self._frame_pixels = (torch.from_numpy(px).to(self.device),
                                  torch.from_numpy(py).to(self.device))
        return self._frame_pixels

    def _render_pool(self, pool: int):
        """`pool` samples of the whole frame in one pooled wavefront;
        returns their (pool, H*W, 3) radiance in pixel order."""
        W, H, TW, TH = self.width, self.height, self.TILE_W, self.TILE_H
        Wp, Hp = -(-W // TW) * TW, -(-H // TH) * TH
        px, py = self._pixels()
        cam = self.camera.params(self.device)
        os_, ds_, streams = [], [], []
        for _ in range(pool):
            jitter, stream = self.draws.next_sample(px.shape[0])
            o, d = generate_rays(cam, px, py, jitter.to(self.device), W, H)
            os_.append(o)
            ds_.append(d)
            streams.append(stream)
        rad = self._radiance(torch.cat(os_), torch.cat(ds_), streams, pool)
        img = (rad.reshape(pool, Hp // TH, Wp // TW, TH, TW, 3)
               .permute(0, 1, 3, 2, 4, 5).reshape(pool, Hp, Wp, 3))
        return img[:, :H, :W].reshape(pool, H * W, 3)

    def _choose_pool(self, spp: int) -> int:
        """Largest divisor of spp within the pool budget (auto: 8 on the
        fused path, else 1).  Only the fused wavefront pools samples
        (engine.py:262-266), so a budget above 1 off it raises."""
        budget = self.spp_pool
        if budget is None:
            budget = DEFAULT_POOL if self.fused else 1
        budget = max(1, min(budget, spp))
        pool = next(p for p in range(budget, 0, -1) if spp % p == 0)
        if pool > 1 and not self.fused:
            raise ValueError(f"spp_pool {self.spp_pool} needs the fused "
                             f"wavefront; {type(self.intersector).__name__} "
                             "renders one sample per wavefront")
        return pool

    def render(self, spp: int = 1) -> np.ndarray:
        """Render the full frame at `spp` samples per pixel into the film;
        returns HDR (H, W, 3) float32 mean radiance."""
        pool = self._choose_pool(spp)
        f = self.film
        for _ in range(spp // pool):
            # sample by sample, so the film does not depend on the pool
            for rad in self._render_pool(pool):
                f.pixel_sum += rad
                f.pixel_sum_sq += rad * rad
            f.num_samples += float(pool)
        return self.get_hdr()

    def get_hdr(self) -> np.ndarray:
        return self.film.get_pixels().cpu().numpy().reshape(
            self.height, self.width, 3)

    def get_tonemapped_image(self) -> np.ndarray:
        """Current film as a tonemapped uint8 (H, W, 3) image (unsampled
        pixels white, like the u32 path)."""
        ldr = simple_map(self.film.get_pixels())
        ldr = torch.where(torch.isnan(ldr), torch.ones_like(ldr),
                          torch.clamp(ldr, 0.0, 1.0))
        return (ldr * 255.0).to(torch.uint8).cpu().numpy().reshape(
            self.height, self.width, 3)

    def render_image(self, spp: int = 1) -> np.ndarray:
        """Tonemapped uint8 (H, W, 3) image."""
        self.render(spp)
        return self.get_tonemapped_image()

    # -- multi-device rendering (parallel/render.py) ----------------------

    def render_sharded(self, spp: int = 1, mesh=None) -> np.ndarray:
        """Full-frame render with pixels sharded over the ranks of a mesh
        (rays data-parallel, scene replicated; default `make_mesh()`).
        Each rank traces its slice of the row-major `pixel_grid` with
        its own draws (`self.draws.split(mesh.size)[mesh.rank]`), pooled
        on the fused path as `render` pools; the per-rank moments are
        all-gathered over the mesh's process group (none on a mesh
        without one), so every rank's film holds the whole frame, folded
        in with a dense add (engine.py:373-411).  The padded pixels are
        traced and dropped."""
        mesh = mesh or make_mesh(device=self.device)
        pool = self._choose_pool(spp)
        key = (mesh, pool)
        if self._sharded_key != key:
            records, has_tex, fused_shade = self._shade_args
            self._sharded_frame = make_sharded_frame_loop(
                mesh, self.intersector, self.width, self.height,
                self.recursions, self.spread, shade_records=records,
                has_textures=has_tex, fused_shade=fused_shade,
                fused_spawn=self.fused, sort_key_mode=self.sort_key_mode,
                spp_pool=pool, sort_payload=self.sort_payload)
            self._sharded_key = key
        px, py, real = pixel_grid(self.width, self.height, pad_to=mesh.size)
        psum, psq = self._sharded_frame(
            self.scene_arrays, self.camera.params(self.device), px, py,
            self.draws.split(mesh.size), spp)
        f = self.film
        f.pixel_sum += all_gather_rays(mesh, psum)[:real]
        f.pixel_sum_sq += all_gather_rays(mesh, psq)[:real]
        f.num_samples += float(spp)
        return self.get_hdr()
