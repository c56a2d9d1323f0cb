"""The reference's own scene reading: a frozen copy of the COLLADA
dialect the configurations use (raytracer-rs colladaloader.rs, as the
port reads it), trimmed to what the benchmark's scenes need, and the
pinhole camera's math (camera.rs, vecmath.rs).  numpy and xml.etree
only; textures decode with PIL, normalised by /256 (texture.rs:34-50).

Conventions kept from the reference: the <p> stream is read in chunks
of three keeping the POSITION index; every node matrix is converted by
reflect_z * transpose(M) * swap_yz and baked into world space as the
row vector product [v, 1] @ E; `xfov` is the field of view of both
axes; camera motion composes rot_x(ax) @ rot_y(ay) @ base.
"""

from __future__ import annotations

import os
from xml.etree import ElementTree

import numpy as np

F = np.float32
DEFAULT_RGB = (1000.0, 0.0, 1000.0)      # RGB::default(), color.rs:37-41


def _local(tag):
    return tag.rsplit("}", 1)[-1]


def _kids(elem, name):
    return [c for c in elem if _local(c.tag) == name]


def _kid(elem, name):
    found = _kids(elem, name)
    if not found:
        raise ValueError(f"no <{name}> in <{_local(elem.tag)}>")
    return found[0]


def _by_attr(elem, key, value):
    for c in elem:
        if c.get(key) == value:
            return c
    raise ValueError(f"no child with {key}={value!r}")


def _floats(text):
    return np.array([float(x) for x in text.split()], dtype=F)


def _m(a):
    return np.asarray(a, dtype=F).reshape(4, 4)


_SWAP_YZ = _m([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
_REFLECT_Z = _m([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]])


def scene_matrix(elems16):
    """A COLLADA node matrix (column-major, Z up) in the scene's
    row-major, Y-up convention (collada_types.rs:76-90)."""
    return (_REFLECT_Z @ _m(elems16).T) @ _SWAP_YZ


def rot_x(radians):
    m = np.eye(4, dtype=F)
    c, s = np.cos(radians, dtype=F), np.sin(radians, dtype=F)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rot_y(radians):
    m = np.eye(4, dtype=F)
    c, s = np.cos(radians, dtype=F), np.sin(radians, dtype=F)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


class Camera:
    """The pinhole camera (camera.rs:22-99): rotation = the orientation
    with its translation and last column cleared; y rotations accumulate
    as the viewer's key presses do."""

    def __init__(self, orientation, fov_deg):
        self.base = _m(orientation)
        rot = self.base.copy()
        rot[:, 3] = 0.0
        rot[3, :3] = 0.0
        rot[3, 3] = 1.0
        self.base_rot = rot
        fov = F(fov_deg) * np.pi / 180.0
        self.max_xy = F(np.tan(0.5 * fov))
        self.x_angle = 0.0
        self.y_angle = 0.0

    def add_y_angle(self, radians):
        self.y_angle += radians

    def matrices(self):
        rotation = (rot_x(self.x_angle) @ rot_y(self.y_angle)) @ self.base_rot
        orientation = (rotation @ np.eye(4, dtype=F)) @ self.base
        return rotation, orientation[3, :3].copy()


def load_texture(path):
    from PIL import Image
    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"), dtype=F)
    return (arr / 256.0).astype(F)


def read_scene(path):
    """The triangle soup, materials, lights, textures and first camera of
    a .dae file, as numpy arrays (world space)."""
    data_dir = os.path.dirname(os.fspath(path))
    with open(path) as f:
        root = ElementTree.fromstring(f.read())
    lib = {_local(c.tag): c for c in root}

    cameras = {}
    for cam in _kids(lib["library_cameras"], "camera"):
        persp = _kid(_kid(_kid(cam, "optics"), "technique_common"),
                     "perspective")
        cameras[cam.get("id")] = float(_kid(persp, "xfov").text.split()[0])
    lights = {}
    for light in _kids(lib["library_lights"], "light"):
        col = _kid(_kid(_kid(light, "technique_common"), "point"), "color")
        lights[light.get("id")] = _floats(col.text)[:3]
    effects = {}
    for eff in _kids(lib["library_effects"], "effect"):
        profile = _kid(eff, "profile_COMMON")
        lambert = _kid(_kid(profile, "technique"), "lambert")
        diffuse = _kid(lambert, "diffuse")
        colors = _kids(diffuse, "color")
        if colors:
            effects[eff.get("id")] = ("rgb", _floats(colors[0].text)[:3])
        else:
            sampler = _kid(diffuse, "texture").get("texture")
            surface = _kid(_kid(_by_attr(profile, "sid", sampler),
                                "sampler2D"), "source").text.strip()
            image = _kid(_kid(_by_attr(profile, "sid", surface), "surface"),
                         "init_from").text.strip()
            effects[eff.get("id")] = ("tex", image)
    images = [(img.get("id"), _kid(img, "init_from").text.strip())
              for img in _kids(lib["library_images"], "image")]
    materials = {m.get("id"): _kid(m, "instance_effect").get("url")[1:]
                 for m in _kids(lib["library_materials"], "material")}
    geometries = {}
    for geom in _kids(lib["library_geometries"], "geometry"):
        gid = geom.get("id")
        mesh = _kid(geom, "mesh")
        pos = _by_attr(_by_attr(mesh, "id", f"{gid}-positions"), "id",
                       f"{gid}-positions-array")
        tris = _kid(mesh, "triangles")
        stream = np.array(_kid(tris, "p").text.split(), dtype=np.int64)
        geometries[gid] = (_floats(pos.text).reshape(-1, 3),
                           stream.reshape(-1, 3)[:, 0], tris.get("material"))

    tri_verts, tri_geom, mat_rgb, mat_tex = [], [], [], []
    light_pos, light_color, camera = [], [], None
    for vs in _kids(lib["library_visual_scenes"], "visual_scene"):
        for node in _kids(vs, "node"):
            url = None
            for inst in ("instance_light", "instance_geometry",
                         "instance_camera"):
                found = _kids(node, inst)
                if found:
                    url = found[0].get("url")[1:]
                    break
            m = scene_matrix(_floats(_kid(node, "matrix").text)[:16])
            if url in cameras and camera is None:
                camera = Camera(m, cameras[url])
            if url in lights:
                light_pos.append((np.array([0, 0, 0, 1], F) @ m)[:3])
                light_color.append(lights[url])
            if url in geometries:
                verts, idx, mat = geometries[url]
                v = verts[idx]
                hom = np.concatenate([v, np.ones((len(v), 1), F)], axis=1)
                tri_verts.append((hom @ m)[:, :3].astype(F).reshape(-1, 3, 3))
                tri_geom.append(np.full(len(v) // 3, len(mat_rgb), np.int64))
                kind, val = effects.get(materials.get(mat), ("rgb", None))
                if val is None:
                    mat_rgb.append(np.array(DEFAULT_RGB, F))
                    mat_tex.append(-1)
                elif kind == "rgb":
                    mat_rgb.append(val.astype(F))
                    mat_tex.append(-1)
                else:
                    mat_rgb.append(np.zeros(3, F))
                    mat_tex.append([i for i, (iid, _) in enumerate(images)
                                    if iid == val][0])
    textures = [load_texture(os.path.join(data_dir, fn)) for _, fn in images]
    if textures:
        hm = max(t.shape[0] for t in textures)
        wm = max(t.shape[1] for t in textures)
        atlas = np.zeros((len(textures), hm, wm, 3), F)
        for i, t in enumerate(textures):
            atlas[i, :t.shape[0], :t.shape[1]] = t
        tex_hw = np.array([t.shape[:2] for t in textures], np.int64)
    else:
        atlas = np.zeros((1, 1, 1, 3), F)
        tex_hw = np.ones((1, 2), np.int64)
    return dict(tri_verts=np.concatenate(tri_verts),
                tri_geom=np.concatenate(tri_geom),
                mat_rgb=np.stack(mat_rgb), mat_tex=np.array(mat_tex),
                light_pos=np.stack(light_pos).astype(F),
                light_color=np.stack(light_color).astype(F),
                atlas=atlas, tex_hw=tex_hw, camera=camera)
