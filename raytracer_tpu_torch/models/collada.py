"""COLLADA (.dae) ingestion: parse + flatten into the scene model.

A copy of ``raytracer_tpu/models/collada.py`` over the port's own
numpy modules (same dialect, same `ColladaError` variants).

Capability parity with the reference loader (reference:
raytracer_lib/src/scene/loaders/colladaloader.rs).  The reference parses
with a hand-rolled combinator crate (`parseval`); the XML machinery is an
implementation detail, so here we use xml.etree and reproduce the
reference's *dialect behavior* exactly:

- Strict top-level library order (colladaloader.rs:59-135): asset,
  library_cameras, library_lights, library_effects, library_images,
  library_materials, library_geometries, library_visual_scenes, scene.
  Out-of-order or missing libraries are an error, like the reference.
- Cameras: `xfov` is the fov for both axes; `aspect_ratio` is parsed and
  ignored (colladaloader.rs:286-311).
- Effects: lambert profile only; diffuse is a color OR a
  texture→sampler→surface→image-id chain (colladaloader.rs:379-424);
  ior from <index_of_refraction><float sid="ior"> (:426-437); optional
  specular from <reflectivity> child with sid="specular" (:439-452).
- Geometries: positions from "{id}-positions(-array)" sources; the <p>
  index stream is consumed in chunks of 3 keeping only the POSITION index
  — NORMAL and TEXCOORD indices are dropped (colladaloader.rs:588-593),
  which is why shading later uses geometric normals and barycentric UVs.
- Visual scenes: every node carries a 4x4 matrix; all nodes across all
  <visual_scene> elements are flattened into one list (:507-548).
- Flattening (to_scene_flatten, :137-273): node-id matching against
  camera/light/geometry ids, light positions transformed by the node
  matrix, triangle de-indexing, node matrix baked into world-space
  vertices, material resolution with Material::default() fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional
from xml.etree import ElementTree

import numpy as np

from raytracer_tpu_torch import native
from raytracer_tpu_torch import vecmath as vm
from raytracer_tpu_torch.models.camera import Camera
from raytracer_tpu_torch.models.texture import load_texture
from raytracer_tpu_torch.models.types import Geometry, Light, Material, Scene
from raytracer_tpu_torch.utils.profiling import span

F = np.float32


class SceneLoadError(Exception):
    """reference: scene/loaders/mod.rs:20-63"""


class ColladaError(SceneLoadError):
    """reference: colladaloader.rs:603-718 — `variant` mirrors the enum
    variant name so tests can assert on failure modes."""

    def __init__(self, variant: str, msg: str = ""):
        self.variant = variant
        super().__init__(f"{variant}: {msg}" if msg else variant)


# Expected order of COLLADA children (colladaloader.rs:71-112).
_LIBRARY_ORDER = [
    "asset", "library_cameras", "library_lights", "library_effects",
    "library_images", "library_materials", "library_geometries",
    "library_visual_scenes", "scene",
]
_ORDER_ERRORS = {
    "asset": "AssetParsing",
    "library_cameras": "LibraryCamerasParsing",
    "library_lights": "LibraryLightsParsing",
    "library_effects": "LibraryEffectsParsing",
    "library_images": "LibraryImagesParsing",
    "library_materials": "LibraryMaterialsParsing",
    "library_geometries": "LibraryGeometriesParsing",
    "library_visual_scenes": "LibraryVisualScenesParsing",
    "scene": "LibrarySceneParsing",
}


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _floats(text: str) -> np.ndarray:
    return native.parse_floats(text)


def _ints(text: str) -> np.ndarray:
    return native.parse_ints(text)


def _child(elem, name):
    for c in elem:
        if _localname(c.tag) == name:
            return c
    raise ColladaError("ElementError", f"no child <{name}> in <{_localname(elem.tag)}>")


def _children(elem, name):
    return [c for c in elem if _localname(c.tag) == name]


def _child_by_attrib(elem, key, value):
    for c in elem:
        if c.get(key) == value:
            return c
    raise ColladaError("ElementError", f"no child with {key}={value!r}")


# --- intermediate structures (reference: collada_types.rs) -----------------


@dataclass
class ColladaCamera:
    id: str
    fov: float
    aspect_ratio: float  # parsed but unused, colladaloader.rs:296-311


@dataclass
class ColladaLight:
    id: str
    pos: np.ndarray
    color: np.ndarray


@dataclass
class ColladaEffect:
    id: str
    emission: np.ndarray            # RGBA
    diffuse_rgba: Optional[np.ndarray]
    diffuse_tex_image_id: Optional[str]
    specular: Optional[float]
    index_of_refraction: float


@dataclass
class ColladaImage:
    id: str
    image_filename: str


@dataclass
class ColladaMaterial:
    id: str
    effect_url: str


@dataclass
class ColladaGeometry:
    vertices: np.ndarray     # flat (3*V,) positions
    triangles: np.ndarray    # (3*T,) POSITION indices
    id: str
    material_id: str


@dataclass
class ColladaVisualSceneNode:
    id: str
    matrix: np.ndarray       # flat (16,) as listed in the document


@dataclass
class Collada:
    cameras: List[ColladaCamera] = field(default_factory=list)
    lights: List[ColladaLight] = field(default_factory=list)
    effects: List[ColladaEffect] = field(default_factory=list)
    images: List[ColladaImage] = field(default_factory=list)
    materials: List[ColladaMaterial] = field(default_factory=list)
    geometries: List[ColladaGeometry] = field(default_factory=list)
    nodes: List[ColladaVisualSceneNode] = field(default_factory=list)

    # -- parse (reference: Collada::parse, colladaloader.rs:59-135) -------

    @staticmethod
    def parse(doc: str) -> "Collada":
        try:
            root = ElementTree.fromstring(doc)
        except ElementTree.ParseError as e:
            raise ColladaError("ParseError", str(e)) from e
        if _localname(root.tag) != "COLLADA":
            raise ColladaError("NotColladaDoc")

        children = list(root)
        names = [_localname(c.tag) for c in children]
        # Enforce the reference's strict ordering: each expected element
        # must appear at the exact position (colladaloader.rs:71-112).
        if len(names) != len(_LIBRARY_ORDER):
            raise ColladaError("RemainingData", f"unexpected children: {names}")
        for want, got in zip(_LIBRARY_ORDER, names):
            if want != got:
                raise ColladaError(_ORDER_ERRORS[want], f"expected <{want}>, found <{got}>")
        by_name = dict(zip(names, children))

        return Collada(
            cameras=_to_cameras(by_name["library_cameras"]),
            lights=_to_lights(by_name["library_lights"]),
            effects=_to_effects(by_name["library_effects"]),
            images=_to_images(by_name["library_images"]),
            materials=_to_materials(by_name["library_materials"]),
            geometries=_to_geometries(by_name["library_geometries"]),
            nodes=_to_visual_scene_nodes(by_name["library_visual_scenes"]),
        )

    # -- flatten (reference: to_scene_flatten, colladaloader.rs:137-273) --

    def to_scene_flatten(self, data_dir, width: int, height: int,
                         verbose: bool = True) -> Scene:
        scene = Scene()

        for image in self.images:
            path = (os.path.join(data_dir, image.image_filename)
                    if data_dir else image.image_filename)
            scene.textures.append(load_texture(path))

        for node in self.nodes:
            for camera in self.cameras:
                if camera.id != node.id:
                    continue
                scene.cameras.append(Camera.from_orientation_matrix(
                    width, height, vm.collada_to_scene_matrix(node.matrix), camera.fov))
                break

            for light in self.lights:
                if light.id != node.id:
                    continue
                m = vm.collada_to_scene_matrix(node.matrix)
                pos = vm.transform_point(m, light.pos)
                scene.lights.append(Light(pos=pos, color=light.color))
                break

            for geometry in self.geometries:
                if geometry.id != node.id:
                    continue
                verts = geometry.vertices.reshape(-1, 3)  # (V, 3)
                tri_verts = verts[geometry.triangles]     # (3*T, 3) de-indexed
                m = vm.collada_to_scene_matrix(node.matrix)
                # Bake the node matrix into world space
                # (colladaloader.rs:209-217): hom point @ E.
                hom = np.concatenate(
                    [tri_verts, np.ones((len(tri_verts), 1), dtype=F)], axis=1)
                world = (hom @ m.reshape(4, 4))[:, :3].astype(F)
                material = self._resolve_material(geometry.material_id)
                scene.geometries.append(Geometry(vertices=world, material=material))
                break

        if verbose:
            # triangle-count printout parity (colladaloader.rs:262-265)
            print(f"number of triangles: {scene.num_triangles}")
        return scene

    def _resolve_material(self, material_id: str) -> Material:
        """colladaloader.rs:219-254 — material → effect → diffuse chain
        with Material::default() fallback at each missing link."""
        mat = next((m for m in self.materials if m.id == material_id), None)
        if mat is None:
            return Material.default()
        eff = next((e for e in self.effects if e.id == mat.effect_url), None)
        if eff is None:
            return Material.default()
        if eff.diffuse_tex_image_id is not None:
            positions = [i for i, img in enumerate(self.images)
                         if img.id == eff.diffuse_tex_image_id]
            if not positions:
                raise ColladaError("MaterialsConversion", "can't find texture name")
            diffuse_rgb, tex_id = (0.0, 0.0, 0.0), positions[0]
        else:
            diffuse_rgb, tex_id = tuple(eff.diffuse_rgba[:3].tolist()), -1
        return Material(
            diffuse_rgb=diffuse_rgb,
            diffuse_tex_id=tex_id,
            emissive=tuple(eff.emission[:3].tolist()),
            specular=eff.specular,
            index_of_refraction=eff.index_of_refraction,
        )


# --- per-library converters (reference: colladaloader.rs:276-601) ----------


def _to_cameras(elem) -> List[ColladaCamera]:
    cameras = []
    for cam in _children(elem, "camera"):
        cam_id = cam.get("id")
        if cam_id is None:
            raise ColladaError("CamerasConversion", "camera without id")
        persp = _child(_child(_child(cam, "optics"), "technique_common"), "perspective")
        try:
            fov = float(_child(persp, "xfov").text.split()[0])
            aspect = float(_child(persp, "aspect_ratio").text.split()[0])
        except (AttributeError, ValueError, IndexError) as e:
            raise ColladaError("CamerasConversion", "cant read fov") from e
        cameras.append(ColladaCamera(id=cam_id, fov=fov, aspect_ratio=aspect))
    return cameras


def _to_lights(elem) -> List[ColladaLight]:
    lights = []
    for light in _children(elem, "light"):
        light_id = light.get("id")
        if light_id is None:
            raise ColladaError("LightsConversion", "light without id")
        color_elem = _child(_child(_child(light, "technique_common"), "point"), "color")
        color = _floats(color_elem.text)[:3]
        # position comes from the visual-scene node (colladaloader.rs:338)
        lights.append(ColladaLight(id=light_id, pos=np.zeros(3, dtype=F), color=color))
    return lights


def _to_effects(elem) -> List[ColladaEffect]:
    effects = []
    for eff in _children(elem, "effect"):
        eff_id = eff.get("id")
        if eff_id is None:
            raise ColladaError("EffectsConversion", "effect without id")
        profile = _child(eff, "profile_COMMON")
        lambert = _child(_child(profile, "technique"), "lambert")

        emission = _floats(_child(_child(lambert, "emission"), "color").text)[:4]

        diffuse_elem = _child(lambert, "diffuse")
        diffuse_rgba = None
        tex_image_id = None
        color_children = _children(diffuse_elem, "color")
        if color_children:
            diffuse_rgba = _floats(color_children[0].text)[:4]
        else:
            # texture → sampler → surface → image id chain
            # (colladaloader.rs:393-423)
            tex = _child(diffuse_elem, "texture")
            sampler_name = tex.get("texture")
            if sampler_name is None:
                raise ColladaError("EffectsConversion", "Cant get sampler")
            surface_name = _child(_child(_child_by_attrib(profile, "sid", sampler_name),
                                         "sampler2D"), "source").text.strip()
            tex_image_id = _child(_child(_child_by_attrib(profile, "sid", surface_name),
                                         "surface"), "init_from").text.strip()

        ior_elem = _child_by_attrib(_child(lambert, "index_of_refraction"), "sid", "ior")
        ior = float(ior_elem.text.split()[0])

        specular = None
        refl = _children(lambert, "reflectivity")
        if refl:
            spec_elem = _child_by_attrib(refl[0], "sid", "specular")
            specular = float(spec_elem.text.split()[0])

        effects.append(ColladaEffect(
            id=eff_id, emission=emission, diffuse_rgba=diffuse_rgba,
            diffuse_tex_image_id=tex_image_id, specular=specular,
            index_of_refraction=ior))
    return effects


def _to_images(elem) -> List[ColladaImage]:
    images = []
    for img in _children(elem, "image"):
        img_id = img.get("id")
        if img_id is None:
            raise ColladaError("ImagesConversion", "image without id")
        filename = _child(img, "init_from").text.strip()
        images.append(ColladaImage(id=img_id, image_filename=filename))
    return images


def _to_materials(elem) -> List[ColladaMaterial]:
    materials = []
    for mat in _children(elem, "material"):
        mat_id = mat.get("id")
        if mat_id is None:
            raise ColladaError("MaterialsConversion", "material without id")
        url = _child(mat, "instance_effect").get("url")
        if url is None:
            raise ColladaError("MaterialsConversion", "instance_effect without url")
        materials.append(ColladaMaterial(id=mat_id, effect_url=url[1:]))  # strip '#'
    return materials


def _to_visual_scene_nodes(elem) -> List[ColladaVisualSceneNode]:
    """All nodes across all visual scenes flatten into one list
    (colladaloader.rs:507-548)."""
    nodes = []
    scenes = _children(elem, "visual_scene")
    if not scenes:
        raise ColladaError("VisualSceneConversion", "No scene element(s)")
    for scene in scenes:
        for node_elem in _children(scene, "node"):
            url = None
            # match order: light, geometry, camera (colladaloader.rs:513-526)
            for inst in ("instance_light", "instance_geometry", "instance_camera"):
                found = _children(node_elem, inst)
                if found:
                    url = found[0].get("url")
                    break
            if url is None:
                raise ColladaError("VisualSceneConversion", "unsupported node type")
            matrix = _floats(_child(node_elem, "matrix").text)
            if len(matrix) < 16:
                raise ColladaError("VisualSceneConversion", "cant create array")
            nodes.append(ColladaVisualSceneNode(id=url[1:], matrix=matrix[:16]))
    return nodes


def _to_geometries(elem) -> List[ColladaGeometry]:
    geometries = []
    for geom in _children(elem, "geometry"):
        geom_id = geom.get("id")
        if geom_id is None:
            raise ColladaError("GeometryConversion")
        mesh = _child(geom, "mesh")
        positions = _child_by_attrib(mesh, "id", f"{geom_id}-positions")
        pos_array = _child_by_attrib(positions, "id", f"{geom_id}-positions-array")
        vertices = _floats(pos_array.text)

        tris_elem = _child(mesh, "triangles")
        material_id = tris_elem.get("material")
        if material_id is None:
            raise ColladaError("GeometryConversion")
        index_stream = _ints(_child(tris_elem, "p").text)
        # chunks of 3 = (POSITION, NORMAL, TEXCOORD); keep only POSITION —
        # normals and texcoords are deliberately dropped
        # (colladaloader.rs:588-593).
        triangles = index_stream.reshape(-1, 3)[:, 0].astype(np.int64)

        geometries.append(ColladaGeometry(
            vertices=vertices, triangles=triangles,
            id=geom_id, material_id=material_id))
    return geometries


class ColladaLoader:
    """reference: SceneLoader trait impl (loaders/mod.rs:6-18,
    colladaloader.rs:22-46)."""

    @staticmethod
    @span("rtx.setup.parse")
    def from_str(doc: str, data_dir=None, width: int = 1024, height: int = 768,
                 verbose: bool = True) -> Scene:
        """The scene of a document: the parse and the flattening
        (textures loaded) run in the span `rtx.setup.parse`."""
        collada = Collada.parse(doc)
        return collada.to_scene_flatten(data_dir, width, height, verbose=verbose)

    @staticmethod
    def from_file(path, width: int = 1024, height: int = 768,
                  verbose: bool = True) -> Scene:
        data_dir = os.path.dirname(os.fspath(path)) or None
        with open(path, "r") as f:
            contents = f.read()
        return ColladaLoader.from_str(contents, data_dir, width, height, verbose=verbose)
