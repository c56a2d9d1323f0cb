"""Embedded demo scene + one-call constructor (PyTorch port of
``raytracer_tpu/inline_scene.py``; the document is generated by the same
code, so it is the same string).

Capability parity with the WASM frontend's hardcoded inline scene
(reference: raytracer_wasm/src/lib.rs:16-25 + inline_data.rs:1-473 — an
inlined COLLADA document rendered at 1024x768 with 70 triangles/leaf,
no filesystem access).  The document here is generated programmatically:
a small octahedron over a ground quad, one point light, one camera —
same Blender-2.80 dialect the loader requires.
"""

from __future__ import annotations

import numpy as np


def _geometry_xml(gid, mat_id, verts, tris):
    pos = " ".join(f"{v:g}" for v in np.asarray(verts, dtype=np.float32).reshape(-1))
    p = " ".join(f"{i} 0 0" for i in np.asarray(tris).reshape(-1))
    nv = len(verts)
    return f"""
    <geometry id="{gid}" name="{gid}">
      <mesh>
        <source id="{gid}-positions">
          <float_array id="{gid}-positions-array" count="{3 * nv}">{pos}</float_array>
          <technique_common>
            <accessor source="#{gid}-positions-array" count="{nv}" stride="3">
              <param name="X" type="float"/><param name="Y" type="float"/><param name="Z" type="float"/>
            </accessor>
          </technique_common>
        </source>
        <vertices id="{gid}-vertices">
          <input semantic="POSITION" source="#{gid}-positions"/>
        </vertices>
        <triangles material="{mat_id}" count="{len(tris)}">
          <input semantic="VERTEX" source="#{gid}-vertices" offset="0"/>
          <input semantic="NORMAL" source="#{gid}-normals" offset="1"/>
          <input semantic="TEXCOORD" source="#{gid}-map-0" offset="2" set="0"/>
          <p>{p}</p>
        </triangles>
      </mesh>
    </geometry>"""


def _build_doc() -> str:
    # COLLADA coords; the identity camera looks along collada +Z
    # (scene -y), so the octahedron sits at z=6 with a backdrop quad
    # at z=9
    s, zc = 1.2, 6.0
    octa_v = [(s, 0, zc), (-s, 0, zc), (0, s, zc), (0, -s, zc),
              (0, 0, zc + s), (0, 0, zc - s)]
    octa_t = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
              (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    g = 6.0
    quad_v = [(-g, -g, 9), (g, -g, 9), (g, g, 9), (-g, g, 9)]
    quad_t = [(0, 2, 1), (0, 3, 2)]  # winding: normal toward the light

    geoms = (_geometry_xml("Octa-mesh", "OctaMat-material", octa_v, octa_t)
             + _geometry_xml("Ground-mesh", "GroundMat-material", quad_v, quad_t))

    def effect(eid, rgba):
        return f"""
    <effect id="{eid}">
      <profile_COMMON><technique sid="common"><lambert>
        <emission><color sid="emission">0 0 0 1</color></emission>
        <diffuse><color sid="diffuse">{rgba}</color></diffuse>
        <index_of_refraction><float sid="ior">1.45</float></index_of_refraction>
      </lambert></technique></profile_COMMON>
    </effect>"""

    cam_matrix = "1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1"
    light_matrix = "1 0 0 2 0 1 0 2 0 0 1 2 0 0 0 1"

    return f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Z_UP</up_axis></asset>
  <library_cameras>
    <camera id="Camera-camera" name="Camera">
      <optics><technique_common><perspective>
        <xfov sid="xfov">39.6</xfov>
        <aspect_ratio>1.333333</aspect_ratio>
        <znear sid="znear">0.1</znear><zfar sid="zfar">100</zfar>
      </perspective></technique_common></optics>
    </camera>
  </library_cameras>
  <library_lights>
    <light id="Light-light" name="Light">
      <technique_common><point>
        <color sid="color">40 40 40</color>
        <constant_attenuation>1</constant_attenuation>
      </point></technique_common>
    </light>
  </library_lights>
  <library_effects>{effect("OctaMat-effect", "0.9 0.35 0.1 1")}{effect("GroundMat-effect", "0.45 0.5 0.55 1")}
  </library_effects>
  <library_images/>
  <library_materials>
    <material id="OctaMat-material"><instance_effect url="#OctaMat-effect"/></material>
    <material id="GroundMat-material"><instance_effect url="#GroundMat-effect"/></material>
  </library_materials>
  <library_geometries>{geoms}
  </library_geometries>
  <library_visual_scenes>
    <visual_scene id="Scene" name="Scene">
      <node id="Camera" name="Camera" type="NODE">
        <matrix sid="transform">{cam_matrix}</matrix>
        <instance_camera url="#Camera-camera"/>
      </node>
      <node id="Light" name="Light" type="NODE">
        <matrix sid="transform">{light_matrix}</matrix>
        <instance_light url="#Light-light"/>
      </node>
      <node id="Octa" name="Octa" type="NODE">
        <matrix sid="transform">1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</matrix>
        <instance_geometry url="#Octa-mesh" name="Octa"/>
      </node>
      <node id="Ground" name="Ground" type="NODE">
        <matrix sid="transform">1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</matrix>
        <instance_geometry url="#Ground-mesh" name="Ground"/>
      </node>
    </visual_scene>
  </library_visual_scenes>
  <scene><instance_visual_scene url="#Scene"/></scene>
</COLLADA>"""


INLINE_SCENE_DOC = _build_doc()


def create_inline_raytracer(width: int = 1024, height: int = 768,
                            triangles_per_leaf: int = 70, device=None,
                            **kwargs):
    """One-call constructor over the embedded scene
    (raytracer_wasm/src/lib.rs:16-25 parity: fixed doc, 70 tris/leaf),
    on `device` (default cuda)."""
    import raytracer_tpu_torch as rtx
    return rtx.create_raytracer(INLINE_SCENE_DOC,
                                triangles_per_leaf=triangles_per_leaf,
                                width=width, height=height, device=device,
                                **kwargs)
