"""Host-side vector/matrix math used by scene loading and cameras.

Capability parity with the reference's hand-rolled math layer
(reference: raytracer_lib/src/vecmath.rs), but array-first: points are
numpy arrays, matrices are flat ``[16]`` float32 buffers interpreted as
row-major 4x4 with the translation in elements 12-14
(vecmath.rs:133-139).

Convention (must match the reference exactly for scene parity):
``M * v`` in the reference computes ``x = v.x*e[0] + v.y*e[4] + v.z*e[8]
+ v.w*e[12]`` (vecmath.rs:204-209), which in matrix terms is the row
vector product ``v @ E`` with ``E = e.reshape(4, 4)``.  Matrix-matrix
products ``A * B`` are plain ``A @ B`` of the reshaped forms
(vecmath.rs:237-313).

A copy of ``raytracer_tpu/vecmath.py`` kept in the PyTorch port so the
port never imports the JAX package.  Device-side (torch) math lives in
``raytracer_tpu_torch.core``; this module is numpy so scene loading
never touches the accelerator.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def vec3(x, y, z) -> np.ndarray:
    return np.array([x, y, z], dtype=F)


def dot(a: np.ndarray, b: np.ndarray) -> np.floating:
    """reference: vecmath.rs:74-76"""
    return F(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """reference: vecmath.rs:78-85"""
    return np.array(
        [a[1] * b[2] - a[2] * b[1],
         a[2] * b[0] - a[0] * b[2],
         a[0] * b[1] - a[1] * b[0]],
        dtype=F,
    )


def normalized(v: np.ndarray) -> np.ndarray:
    """reference: vecmath.rs:23-27"""
    return (v / np.sqrt(np.sum(v * v))).astype(F)


# --- 4x4 matrices, stored as flat [16] float32 (row-major reshape) ---------


def mat_ident() -> np.ndarray:
    """reference: vecmath.rs:107-114"""
    return np.eye(4, dtype=F).reshape(-1)


def mat_rot_x(radians: float) -> np.ndarray:
    """reference: vecmath.rs:116-123 (note the sign layout: e[6]=-sin)."""
    m = mat_ident()
    c, s = np.cos(radians, dtype=F), np.sin(radians, dtype=F)
    m[5], m[6], m[9], m[10] = c, -s, s, c
    return m


def mat_rot_y(radians: float) -> np.ndarray:
    """reference: vecmath.rs:124-131 (e[2]=sin, e[8]=-sin)."""
    m = mat_ident()
    c, s = np.cos(radians, dtype=F), np.sin(radians, dtype=F)
    m[0], m[2], m[8], m[10] = c, s, -s, c
    return m


def mat_translate(v: np.ndarray) -> np.ndarray:
    """reference: vecmath.rs:133-139 — translation in elements 12..14."""
    m = mat_ident()
    m[12], m[13], m[14] = v[0], v[1], v[2]
    return m


def mat_transpose(m: np.ndarray) -> np.ndarray:
    """reference: vecmath.rs:141-159"""
    return np.ascontiguousarray(m.reshape(4, 4).T, dtype=F).reshape(-1)


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a * b`` in reference operator terms (vecmath.rs:237-313)."""
    return (a.reshape(4, 4).astype(F) @ b.reshape(4, 4).astype(F)).reshape(-1)


def mat_mul_vec4(m: np.ndarray, v4: np.ndarray) -> np.ndarray:
    """``m * v`` in reference operator terms = row-vector v @ E
    (vecmath.rs:200-211)."""
    return (np.asarray(v4, dtype=F) @ m.reshape(4, 4).astype(F)).astype(F)


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Transform a 3D point with w=1 (reference: Vec4::from_vec3 then M*v,
    vecmath.rs:64-72 + 200-211), returning xyz."""
    v4 = np.array([p[0], p[1], p[2], 1.0], dtype=F)
    return mat_mul_vec4(m, v4)[:3]


# --- COLLADA coordinate-system conversion ----------------------------------

_SWAP_YZ = np.array(
    [[1, 0, 0, 0],
     [0, 0, 1, 0],
     [0, 1, 0, 0],
     [0, 0, 0, 1]], dtype=F).reshape(-1)

_REFLECT_Z = np.array(
    [[1, 0, 0, 0],
     [0, 1, 0, 0],
     [0, 0, -1, 0],
     [0, 0, 0, 1]], dtype=F).reshape(-1)


def collada_to_scene_matrix(elems16) -> np.ndarray:
    """Convert a COLLADA node matrix (column-major, Z-up, right-handed) to
    the scene's row-major, Y-up, left-handed convention.

    reference: collada_types.rs:76-90 —
    ``reflect_z * transpose(M) * swap_yx``.
    """
    row_major = mat_transpose(np.asarray(elems16, dtype=F).reshape(-1))
    return mat_mul(mat_mul(_REFLECT_Z, row_major), _SWAP_YZ)
