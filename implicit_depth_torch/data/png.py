"""PNG reading and writing on ``zlib``, without OpenCV or Pillow.

:func:`read_png` reads non-interlaced 8-bit grey, grey + alpha, RGB, RGBA
and palette images and 16-bit grey, with every scanline filter (0-4); any
other file raises a ``ValueError`` that names what it is. :func:`write_png`
writes 8-bit grey and RGB, 16-bit grey, and palette images (indices plus a
palette, as ``seg_io.imwrite_indexed`` stores masks).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha",
                6: "RGBA"}


def _chunks(data: bytes):
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters: ``raw`` (H, stride) filtered bytes,
    ``filters`` (H,) their types, ``bpp`` bytes a pixel (at least 1)."""
    h, stride = raw.shape
    if filters.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(filters.max())} (0-4 exist)")
    out = np.zeros((h, stride), np.uint8)
    if not np.isin(filters, (3, 4)).any():
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            row, f = raw[r], filters[r]
            if f == 1:  # Sub: a running sum over each byte of the pixel
                row = np.cumsum(row.reshape(-1, bpp), 0,
                                dtype=np.uint8).reshape(-1)
            elif f == 2:  # Up
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    # Average or Paeth somewhere: sweep the anti-diagonals r + p (p the
    # pixel), each of which needs only the two before it, all rows at once
    w = stride // bpp
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column
    src = raw.reshape(h, w, bpp).astype(np.int32)
    for t in range(h + w - 1):
        rs = np.arange(max(0, t - w + 1), min(h, t + 1))
        ps = t - rs
        a = rec[rs + 1, ps]      # left
        b = rec[rs, ps + 1]      # up
        c = rec[rs, ps]          # up-left
        f = filters[rs][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[rs + 1, ps + 1] = (src[rs, ps] + pred) & 255
    return rec[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str, with_palette: bool = False):
    """The stored samples of a PNG: (H, W) grey or palette indices, (H, W,
    2) grey + alpha, (H, W, 3) RGB, (H, W, 4) RGBA; uint8, or uint16 for
    16-bit grey. ``with_palette``: also return the (n, 3) uint8 palette
    (None unless the image has one)."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, comp, filt, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} does not exist")
    name = f"{depth}-bit {_COLOR_NAMES[color]}"
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG, {name}: not read")
    if comp or filt:
        raise ValueError(f"{path}: PNG compression method {comp} / filter "
                         f"method {filt}: not read")
    if not (depth == 8 or (depth == 16 and color == 0)):
        raise ValueError(f"{path}: {name} PNG: reads 8-bit grey, grey + "
                         "alpha, RGB, RGBA, palette and 16-bit grey")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data of {buf.size} bytes, "
                         f"{h * (stride + 1)} expected")
    buf = buf.reshape(h, stride + 1)
    rows = _unfilter(buf[:, 1:], buf[:, 0].astype(np.int64), bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w)
    else:
        img = rows.reshape(h, w, ch)
        img = img[..., 0] if ch == 1 else img
    img = np.ascontiguousarray(img)
    return (img, palette) if with_palette else img


def read_png_gray(path: str) -> np.ndarray:
    """An 8-bit PNG as one grey channel, as ``cv2.imread(path,
    IMREAD_GRAYSCALE)`` gives it: palette images through their colours,
    colour through libpng's ``rgb_to_gray`` (coefficients 9797, 19234, 3737
    of 32768, truncated), alpha dropped."""
    img, palette = read_png(path, with_palette=True)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: read_png_gray takes an 8-bit PNG")
    if palette is not None:
        img = palette[img]
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.int64)
    gray = (9797 * rgb[..., 0] + 19234 * rgb[..., 1]
            + 3737 * rgb[..., 2]) >> 15
    return gray.astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray,
              palette: Optional[np.ndarray] = None) -> None:
    """``img``: (H, W) grey or (H, W, 3) RGB uint8; (H, W) uint16 grey
    (16-bit); or, with ``palette`` ((n <= 256, 3) uint8), (H, W) uint8
    indices into it."""
    img = np.ascontiguousarray(img)
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if img.dtype != np.uint8 or img.ndim != 2 or len(pal) > 256:
            raise ValueError(f"a palette PNG takes (H, W) uint8 indices and "
                             f"at most 256 colours, not {img.shape} "
                             f"{img.dtype}, {len(pal)} colours")
        depth, color, rows = 8, 3, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, color, rows = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        depth, color, rows = 8, 0 if img.ndim == 2 else 2, img
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8 or "
                         f"(H, W) uint16, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = rows.reshape(h, -1)
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    parts = [_SIGNATURE,
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, 0))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", pal.tobytes()))
    parts += [_chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))

