"""PNG write/read helpers for headless output (port of
``raytracer_tpu/utils/png_io.py``).

The reference shows frames in a native window / browser canvas
(raytracer/src/main.rs:221-253, raytracer_wasm); here frames go to PNG
files and to the live viewer (raytracer_tpu_torch.viewer).  PIL is used
when present; without it a minimal stdlib encoder (zlib) writes the
file, so the port has no hard imaging dependency.  `encode_png` is that
encoder (the viewer serves its bytes), `decode_png` its inverse, for
checks on a machine without PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG (filter 0 on
    every row, zlib level 6)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path, image: np.ndarray):
    """image: (H, W, 3) uint8."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    try:
        from PIL import Image
        Image.fromarray(image).save(path)
        return
    except ImportError:
        pass
    with open(path, "wb") as f:
        f.write(encode_png(image))


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG as `encode_png` writes it (8-bit RGB, no
    interlace, filter 0 on every row) -> (H, W, 3) uint8.  Raises
    ValueError on anything else, e.g. a PIL file with adaptive row
    filters."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"PNG header {hdr}: only 8-bit RGB, no interlace")
    w, h = hdr[0], hdr[1]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + 3 * w):
        raise ValueError(f"PNG data: {len(raw)} bytes for {w}x{h}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("PNG rows use filters other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def u32_to_rgba8(pixels_u32: np.ndarray, width: int, height: int) -> np.ndarray:
    """Unpack 0xAARRGGBB u32 pixels into (H, W, 4) uint8 — the repack the
    WASM frontend does before putImageData (raytracer_wasm/src/lib.rs:46-52)."""
    p = pixels_u32.reshape(height, width).astype(np.uint32)
    r = (p >> 16) & 0xFF
    g = (p >> 8) & 0xFF
    b = p & 0xFF
    a = (p >> 24) & 0xFF
    return np.stack([r, g, b, a], axis=-1).astype(np.uint8)
