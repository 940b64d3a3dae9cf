"""Minimal PNG writer (stdlib zlib + struct): 8-bit grayscale, RGB or RGBA.

The panorama stitcher's only image output format; keeps the main path free
of imaging packages.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # channels -> PNG color type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4) array as a PNG file
    (no interlace; every scanline uses filter type 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png needs (H, W[, 3|4]) pixels, got "
                         f"{img.shape}")
    h, w, c = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
