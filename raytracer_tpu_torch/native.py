"""ctypes loader for the native C++ host parser (repo-root
``csrc/rtx_native.cpp``).

The port's own loader of the same source (the JAX package's
``raytracer_tpu/native`` cannot be imported without JAX): it compiles
the shared library on first use with g++ into ``build/torch_native/``
and binds the two parsers the COLLADA loader uses, the de-indexing
gather and the Morton sort of the cluster-grid builder.  Each has the
same numpy fallback, so scene loading works without a toolchain; this
is host work, not the device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "csrc", "rtx_native.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
_LIB_PATH = os.path.join(_BUILD_DIR, "librtx_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    """Build into a per-process file and move it into place, so parallel
    builders never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        stale = (not os.path.exists(_LIB_PATH)
                 or (os.path.exists(_SRC)
                     and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)))
        if stale and not _compile():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.rtx_parse_floats.restype = ctypes.c_long
        lib.rtx_parse_floats.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.rtx_parse_ints.restype = ctypes.c_long
        lib.rtx_parse_ints.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
        lib.rtx_deindex.restype = None
        lib.rtx_deindex.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        lib.rtx_morton_order.restype = None
        lib.rtx_morton_order.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def parse_floats(text: str) -> np.ndarray:
    """Whitespace-separated float stream -> float32 array."""
    lib = _load()
    data = text.encode()
    if lib is not None:
        cap = len(data) // 2 + 2  # >= number of tokens
        out = np.empty(cap, dtype=np.float32)
        n = lib.rtx_parse_floats(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
        if n >= 0:
            return out[:n].copy()
    return np.array([float(x) for x in text.split()], dtype=np.float32)


def parse_ints(text: str) -> np.ndarray:
    """Whitespace-separated integer stream -> int64 array."""
    lib = _load()
    data = text.encode()
    if lib is not None:
        cap = len(data) // 2 + 2
        out = np.empty(cap, dtype=np.int64)
        n = lib.rtx_parse_ints(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if n >= 0:
            return out[:n].copy()
    return np.array([int(x) for x in text.split()], dtype=np.int64)


def deindex(verts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """verts (V, 3) float32 + position indices (3T,) -> (3T, 3) float32."""
    lib = _load()
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if lib is not None:
        out = np.empty((len(idx), 3), dtype=np.float32)
        lib.rtx_deindex(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    return verts[idx]


def morton_order(tri_verts: np.ndarray) -> np.ndarray:
    """tris (N, 3, 3) float32 -> stable Morton argsort (N,) int32."""
    lib = _load()
    tris = np.ascontiguousarray(tri_verts, dtype=np.float32)
    if lib is not None:
        out = np.empty(len(tris), dtype=np.int32)
        lib.rtx_morton_order(
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(tris),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    from raytracer_tpu_torch.ops.cluster import morton_codes
    centroids = tris.mean(axis=1)
    lo = tris.reshape(-1, 3).min(axis=0)
    hi = tris.reshape(-1, 3).max(axis=0)
    return np.argsort(morton_codes(centroids, lo, hi),
                      kind="stable").astype(np.int32)
