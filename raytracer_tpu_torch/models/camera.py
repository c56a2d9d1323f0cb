"""Pinhole camera with interactive rotate/move and batched jittered ray-gen
(PyTorch port of ``raytracer_tpu/models/camera.py``).

Reference: raytracer_lib/src/scene/camera.rs:5-99, with its two quirks:

- `xfov` drives BOTH axes; the COLLADA aspect ratio is parsed but ignored
  (camera.rs:41-44), so max_x == max_y == tan(fov/2).
- The y direction is negated in ray dirs (camera.rs:85) and ray dirs are
  NOT normalized (z component fixed at 1 pre-rotation).

`Camera` is host (numpy) state; `params(device)` hands its rotation,
origin and film half-extents to the batched torch `generate_rays`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from raytracer_tpu_torch import vecmath as vm
from raytracer_tpu_torch.models.types import resolve_device

F = np.float32


@dataclass
class CameraParams:
    """rot:    (4, 4) float32 tensor — rotation matrix (row-vector convention)
    origin: (3,)   float32 tensor — camera position ((0,0,0,1) @ orientation)
    max_x, max_y: float32 0-d tensors, film half-extents at z=1
    (camera.rs:41-44)"""
    rot: torch.Tensor
    origin: torch.Tensor
    max_x: torch.Tensor
    max_y: torch.Tensor

    @classmethod
    def from_numpy(cls, fields, device=None) -> "CameraParams":
        """`fields`: a mapping (or object with attributes) of array-likes
        named rot, origin, max_x, max_y, e.g. the numpy values of the JAX
        package's CameraParams; float32 tensors on `device`."""
        dev = resolve_device(device)
        get = (fields.__getitem__ if isinstance(fields, dict)
               else lambda n: getattr(fields, n))
        return cls(**{n: torch.from_numpy(
                          np.array(get(n), dtype=np.float32)).to(dev)
                      for n in ("rot", "origin", "max_x", "max_y")})


class Camera:
    """Interactive camera state (host side).

    Construction mirrors `Camera::from_orientation_matrix`
    (camera.rs:22-61): the rotation matrix is the orientation matrix with
    its translation row (e[12..14]) and last column (e[3], e[7], e[11])
    zeroed, e[15] = 1.
    """

    def __init__(self, width: int, height: int, orientation_matrix: np.ndarray,
                 fov_deg: float):
        rot = np.array(orientation_matrix, dtype=F).reshape(-1).copy()
        rot[3] = rot[7] = rot[11] = 0.0
        rot[12] = rot[13] = rot[14] = 0.0
        rot[15] = 1.0

        fov = F(fov_deg) * np.pi / 180.0
        self.max_x = F(np.tan(0.5 * fov))
        self.max_y = F(np.tan(0.5 * fov))  # aspect ratio ignored, camera.rs:41-44

        self.width = width
        self.height = height
        self.x_angle_radians = 0.0
        self.y_angle_radians = 0.0
        self.pos = np.zeros(3, dtype=F)
        self.base_orientation_matrix = np.array(orientation_matrix, dtype=F).reshape(-1)
        self.base_rotation_matrix = rot
        self.orientation_matrix = vm.mat_ident()
        self.rotation_matrix = vm.mat_ident()
        self._update_matrices()

    @staticmethod
    def from_orientation_matrix(width, height, orientation_matrix, fov_deg):
        return Camera(width, height, orientation_matrix, fov_deg)

    # -- interactive controls (each invalidates the film upstream,
    #    reference: raytracer/src/main.rs:123-163) ------------------------

    def add_x_angle(self, radians: float):
        """camera.rs:63-66"""
        self.x_angle_radians += radians
        self._update_matrices()

    def add_y_angle(self, radians: float):
        """camera.rs:68-71"""
        self.y_angle_radians += radians
        self._update_matrices()

    def move_rel(self, x: float, y: float, z: float):
        """camera.rs:73-78"""
        self.pos = self.pos + np.array([x, y, z], dtype=F)
        self._update_matrices()

    def _update_matrices(self):
        """camera.rs:92-98"""
        self.rotation_matrix = vm.mat_mul(
            vm.mat_mul(vm.mat_rot_x(self.x_angle_radians),
                       vm.mat_rot_y(self.y_angle_radians)),
            self.base_rotation_matrix,
        )
        self.orientation_matrix = vm.mat_mul(
            vm.mat_mul(self.rotation_matrix, vm.mat_translate(self.pos)),
            self.base_orientation_matrix,
        )

    # -- device params ----------------------------------------------------

    def params(self, device=None) -> CameraParams:
        dev = resolve_device(device)
        origin = self.orientation_matrix[12:15]  # (0,0,0,1) @ O, camera.rs:88
        return CameraParams(
            rot=torch.from_numpy(self.rotation_matrix.reshape(4, 4).copy()).to(dev),
            origin=torch.from_numpy(origin.copy()).to(dev),
            max_x=torch.tensor(self.max_x, dtype=torch.float32, device=dev),
            max_y=torch.tensor(self.max_y, dtype=torch.float32, device=dev),
        )

    def get_ray(self, u: int, v: int, jitter=(0.5, 0.5)):
        """Scalar single-ray generation (host/numpy) — the direct analogue
        of Camera::get_ray (camera.rs:80-90)."""
        dir_x = -self.max_x + 2.0 * self.max_x * ((u + jitter[0]) / self.width)
        dir_y = -self.max_y + 2.0 * self.max_y * ((v + jitter[1]) / self.height)
        d4 = np.array([dir_x, -dir_y, 1.0, 1.0], dtype=F)
        d = vm.mat_mul_vec4(self.rotation_matrix, d4)[:3]
        pos = self.orientation_matrix[12:15].copy()
        return pos, d


def generate_rays(cam: CameraParams, px: torch.Tensor, py: torch.Tensor,
                  jitter: torch.Tensor, width: int, height: int):
    """Batched jittered primary-ray generation.

    px, py: (R,) integer pixel coordinates; jitter: (R, 2) in [0, 1).
    Returns (origins (R, 3), dirs (R, 3)); dirs are unnormalized with the
    pre-rotation z component = 1, exactly like camera.rs:80-90.  The
    3x3 rotation is written out as row-vector dot products, each summed
    left to right.
    """
    dir_x = -cam.max_x + 2.0 * cam.max_x * ((px.float() + jitter[:, 0]) / width)
    dir_y = -cam.max_y + 2.0 * cam.max_y * ((py.float() + jitter[:, 1]) / height)
    nyy = -dir_y
    r = cam.rot
    dirs = torch.stack(
        [dir_x * r[0, c] + nyy * r[1, c] + r[2, c] for c in range(3)], dim=-1)
    origins = cam.origin.expand(dirs.shape)
    return origins, dirs
