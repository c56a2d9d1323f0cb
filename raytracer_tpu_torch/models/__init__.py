"""Scene model: containers, camera, textures, and the COLLADA loader
(PyTorch port of ``raytracer_tpu/models``)."""

from raytracer_tpu_torch.models.types import (
    Material, Light, Scene, Geometry, SceneBuffers, SceneArrays,
    DEBUG_MAGENTA,
)
from raytracer_tpu_torch.models.camera import Camera
from raytracer_tpu_torch.models.texture import Texture, load_texture

__all__ = [
    "Material", "Light", "Scene", "Geometry", "SceneBuffers", "SceneArrays",
    "Camera", "Texture", "load_texture", "DEBUG_MAGENTA",
]
