"""A small PNG writer (8-bit gray or RGB, zlib), so that the port writes its
visual dumps without OpenCV or Pillow."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """``img``: (H, W) gray or (H, W, 3) RGB, uint8."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                            0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
