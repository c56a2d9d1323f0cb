"""Scene containers and their flat SoA device form (PyTorch port of
``raytracer_tpu/models/types.py``).

`Scene`, `Material`, `Light`, `Geometry` and `SceneBuffers` are the
reference's host (numpy) containers, copied unchanged.  `SceneArrays`
is a plain dataclass of torch tensors on one device (no pytree
registration: PyTorch runs eagerly and takes the dataclass as is).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

F = np.float32

# Un-set materials render debug magenta, like the reference's
# `RGB::default()` (reference: scene/color.rs:37-41).
DEBUG_MAGENTA = (1000.0, 0.0, 1000.0)


def resolve_device(device=None) -> torch.device:
    """The port's device rule: `cuda` unless the caller asks for another
    device; asking for CUDA without a card raises (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "raytracer_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain versions")
    return dev


@dataclass
class Material:
    """reference: scene/mod.rs:63-69.  `diffuse` is either an RGB triple or
    a texture id (`Diffuse` enum, scene/color.rs:98-108); here: rgb plus
    tex_id with tex_id < 0 meaning 'use rgb'."""
    diffuse_rgb: tuple = DEBUG_MAGENTA
    diffuse_tex_id: int = -1
    emissive: tuple = DEBUG_MAGENTA
    specular: Optional[float] = None
    index_of_refraction: float = 0.0

    @staticmethod
    def default() -> "Material":
        """reference: Material::default() via derive(Default) with
        RGB::default() = (1000, 0, 1000) (scene/color.rs:37-41)."""
        return Material()


@dataclass
class Light:
    """reference: scene/mod.rs:12-22"""
    pos: np.ndarray
    color: np.ndarray


@dataclass
class Geometry:
    """De-indexed triangle soup: vertices.shape == (3*T, 3)
    (reference: scene/mod.rs:46-61)."""
    vertices: np.ndarray
    material: Material

    @property
    def num_triangles(self) -> int:
        return len(self.vertices) // 3


@dataclass
class Scene:
    """reference: scene/mod.rs:24-29.  `cameras` holds Camera objects from
    models.camera; `textures` holds (H, W, 3) float32 arrays."""
    geometries: List[Geometry] = field(default_factory=list)
    lights: List[Light] = field(default_factory=list)
    cameras: list = field(default_factory=list)
    textures: List[np.ndarray] = field(default_factory=list)

    @property
    def num_triangles(self) -> int:
        return sum(g.num_triangles for g in self.geometries)

    def apply_transform(self, matrix16) -> None:
        """Re-transform every geometry's vertices by a flat [16] matrix
        (reference: Scene::apply_transform, scene/mod.rs:33-43)."""
        m = np.asarray(matrix16, dtype=F).reshape(4, 4)
        for g in self.geometries:
            hom = np.concatenate(
                [g.vertices, np.ones((len(g.vertices), 1), dtype=F)], axis=1)
            g.vertices = (hom @ m)[:, :3].astype(F)

    def to_buffers(self) -> "SceneBuffers":
        return SceneBuffers.from_scene(self)


@dataclass
class SceneBuffers:
    """Flat SoA form of a Scene (host/numpy).

    Shapes (N = total triangles, G = geometries, L = lights, T = textures):
      tri_verts    (N, 3, 3)  v0/v1/v2 world-space (node transforms baked at
                              load, like colladaloader.rs:209-217)
      tri_geom     (N,)       geometry index per triangle (material lookup)
      mat_*        (G, ...)   per-geometry material table
      light_*      (L, ...)   point lights
      tex_atlas    (T, Hm, Wm, 3)  textures padded to common max dims
      tex_hw       (T, 2)     true (H, W) per texture
    """
    tri_verts: np.ndarray
    tri_geom: np.ndarray
    mat_diffuse_rgb: np.ndarray
    mat_tex_id: np.ndarray
    mat_emissive: np.ndarray
    mat_specular: np.ndarray
    mat_ior: np.ndarray
    light_pos: np.ndarray
    light_color: np.ndarray
    tex_atlas: np.ndarray
    tex_hw: np.ndarray

    @staticmethod
    def from_scene(scene: Scene) -> "SceneBuffers":
        verts_list, geom_ids = [], []
        G = max(len(scene.geometries), 1)
        mat_rgb = np.full((G, 3), 0.0, dtype=F)
        mat_tex = np.full((G,), -1, dtype=np.int32)
        mat_emit = np.zeros((G, 3), dtype=F)
        mat_spec = np.zeros((G,), dtype=F)
        mat_ior = np.zeros((G,), dtype=F)
        for gi, geom in enumerate(scene.geometries):
            v = np.asarray(geom.vertices, dtype=F).reshape(-1, 3, 3)
            verts_list.append(v)
            geom_ids.append(np.full((len(v),), gi, dtype=np.int32))
            m = geom.material
            mat_rgb[gi] = np.asarray(m.diffuse_rgb, dtype=F)
            mat_tex[gi] = np.int32(m.diffuse_tex_id)
            mat_emit[gi] = np.asarray(m.emissive, dtype=F)
            # The reference carries specular as Option<f32> but shading uses
            # a hardcoded white specular regardless (raytracer/mod.rs:240);
            # we store the loaded value for parity/introspection.
            mat_spec[gi] = F(m.specular if m.specular is not None else 0.0)
            mat_ior[gi] = F(m.index_of_refraction)

        if verts_list:
            tri_verts = np.concatenate(verts_list, axis=0)
            tri_geom = np.concatenate(geom_ids, axis=0)
        else:
            tri_verts = np.zeros((0, 3, 3), dtype=F)
            tri_geom = np.zeros((0,), dtype=np.int32)

        L = len(scene.lights)
        light_pos = np.stack([l.pos for l in scene.lights]).astype(F) if L else np.zeros((0, 3), F)
        light_color = np.stack([l.color for l in scene.lights]).astype(F) if L else np.zeros((0, 3), F)

        T = len(scene.textures)
        if T:
            hm = max(t.shape[0] for t in scene.textures)
            wm = max(t.shape[1] for t in scene.textures)
            tex_atlas = np.zeros((T, hm, wm, 3), dtype=F)
            tex_hw = np.zeros((T, 2), dtype=np.int32)
            for ti, t in enumerate(scene.textures):
                tex_atlas[ti, : t.shape[0], : t.shape[1]] = t
                tex_hw[ti] = (t.shape[0], t.shape[1])
        else:
            # Placeholder so the texel fetch always has an operand (dead
            # when no material references it).
            tex_atlas = np.zeros((1, 1, 1, 3), dtype=F)
            tex_hw = np.ones((1, 2), dtype=np.int32)

        return SceneBuffers(
            tri_verts=tri_verts, tri_geom=tri_geom,
            mat_diffuse_rgb=mat_rgb, mat_tex_id=mat_tex, mat_emissive=mat_emit,
            mat_specular=mat_spec, mat_ior=mat_ior,
            light_pos=light_pos, light_color=light_color,
            tex_atlas=tex_atlas, tex_hw=tex_hw,
        )

    def to_device(self, device=None) -> "SceneArrays":
        return SceneArrays.from_numpy(self, device)


@dataclass
class SceneArrays:
    """Device mirror of SceneBuffers: every field a torch tensor on one
    device (float32 / int32, the numpy dtypes)."""
    tri_verts: torch.Tensor
    tri_geom: torch.Tensor
    mat_diffuse_rgb: torch.Tensor
    mat_tex_id: torch.Tensor
    mat_emissive: torch.Tensor
    mat_specular: torch.Tensor
    mat_ior: torch.Tensor
    light_pos: torch.Tensor
    light_color: torch.Tensor
    tex_atlas: torch.Tensor
    tex_hw: torch.Tensor

    @classmethod
    def from_numpy(cls, fields, device=None) -> "SceneArrays":
        """`fields`: a mapping (or object with attributes) of numpy
        arrays named like SceneArrays' fields, e.g. a SceneBuffers."""
        dev = resolve_device(device)
        get = (fields.__getitem__ if isinstance(fields, dict)
               else lambda n: getattr(fields, n))
        return cls(**{f.name: torch.from_numpy(
                          np.ascontiguousarray(get(f.name))).to(dev)
                      for f in dataclasses.fields(cls)})

    def to_device(self, device) -> "SceneArrays":
        dev = resolve_device(device)
        return SceneArrays(**{f.name: getattr(self, f.name).to(dev)
                              for f in dataclasses.fields(self)})

    @property
    def num_triangles(self) -> int:
        return self.tri_verts.shape[0]
