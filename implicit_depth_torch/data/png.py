"""PNG reading and writing on ``zlib``, without OpenCV or Pillow.

:func:`read_png` reads every image the PNG standard defines: grey at 1, 2,
4, 8 and 16 bits, palette at 1, 2, 4 and 8 bits, grey + alpha, RGB and RGBA
at 8 and 16 bits, each plain or Adam7-interlaced, with every scanline
filter (0-4); it returns the stored samples. :func:`read_png_pillow` gives
them as Pillow's ``np.array(Image.open(path))`` does, :func:`read_png_gray`
as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` does. A colour type and bit
depth the standard does not pair, another compression, filter or interlace
method raise a ``ValueError`` that names it. :func:`write_png` writes 8-bit
grey and RGB, 16-bit grey, and palette images (indices plus a palette, as
``seg_io.imwrite_indexed`` stores masks).
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
# the bit depths the standard allows for each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: each pass's first row and column and its row and column steps
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
# libpng's rgb_to_gray weights as OpenCV asks for them (0.299, 0.587 of
# 32768, truncated; blue the rest)
_GRAY_W = (9797, 19234, 3737)


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


def _unpack(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, n) samples: big-endian uint16 at
    16 bits, bytes at 8, MSB-first fields below (uint8)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :n]
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
    fields = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return fields.reshape(h, -1)[:, :n].astype(np.uint8)


def _pass_samples(buf: np.ndarray, pos: int, h: int, w: int, depth: int,
                  ch: int, path: str):
    """One image or interlace pass of ``h`` x ``w`` pixels from the
    decompressed stream at ``pos`` -> ((h, w·ch) samples, the next pos)."""
    stride = (w * ch * depth + 7) // 8
    n = h * (stride + 1)
    if pos + n > buf.size:
        raise ValueError(f"{path}: PNG image data ends early "
                         f"({buf.size} bytes)")
    raw = buf[pos:pos + n].reshape(h, stride + 1)
    rows = _unfilter(raw[:, 1:], raw[:, 0].astype(np.int64),
                     max(1, ch * depth // 8))
    return _unpack(rows, depth, w * ch), pos + n


def _read(path: str):
    """(samples (H, W, channels), bit depth, colour type, palette or
    None)."""
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
    if depth not in _DEPTHS[color]:
        raise ValueError(f"{path}: a {depth}-bit {_COLOR_NAMES[color]} PNG "
                         f"does not exist ({_COLOR_NAMES[color]} takes "
                         f"{_DEPTHS[color]} bits)")
    if comp or filt or interlace > 1:
        raise ValueError(f"{path}: PNG compression method {comp} / filter "
                         f"method {filt} / interlace method {interlace}: "
                         "not read")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[color]
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        img, end = _pass_samples(buf, 0, h, w, depth, ch, path)
        img = img.reshape(h, w, ch)
    else:
        img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        end = 0
        for r0, c0, dr, dc in _ADAM7:
            ph, pw = -(-(h - r0) // dr), -(-(w - c0) // dc)
            if ph > 0 and pw > 0:
                sub, end = _pass_samples(buf, end, ph, pw, depth, ch, path)
                img[r0::dr, c0::dc] = sub.reshape(ph, pw, ch)
    if end != buf.size:
        raise ValueError(f"{path}: PNG image data of {buf.size} bytes, "
                         f"{end} expected")
    return np.ascontiguousarray(img), depth, color, palette


def read_png(path: str, with_palette: bool = False):
    """The stored samples of a PNG: (H, W) grey or palette indices, (H, W,
    2) grey + alpha, (H, W, 3) RGB, (H, W, 4) RGBA; uint8 at 1-8 bits (the
    values as stored, 0 to 2^depth - 1), uint16 at 16. ``with_palette``:
    also return the (n, 3) uint8 palette (None unless the image has
    one)."""
    img, _, _, palette = _read(path)
    img = np.ascontiguousarray(img[..., 0]) if img.shape[2] == 1 else img
    return (img, palette) if with_palette else img


def _high_bytes(img: np.ndarray) -> np.ndarray:
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def read_png_pillow(path: str) -> np.ndarray:
    """A PNG as Pillow's ``np.array(Image.open(path))`` gives it: 1-bit
    grey as bool, 2- and 4-bit grey scaled to 8 bits, palette images as
    their indices at any depth, 16-bit grey as uint16, 16-bit colour as the
    high bytes (grey + alpha as RGBA, the grey in R, G and B); every other
    image its stored samples."""
    img, depth, color, _ = _read(path)
    if color == 0 and depth < 8:
        img = img[..., 0]
        return img.astype(bool) if depth == 1 else \
            img * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16 and color != 0:
        img = _high_bytes(img)
        if color == 4:
            img = img[..., [0, 0, 0, 1]]
        return np.ascontiguousarray(img)
    return np.ascontiguousarray(img[..., 0]) if img.shape[2] == 1 else img


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) uint8 RGB, as ``cv2.cvtColor(cv2.imread(path),
    cv2.COLOR_BGR2RGB)`` gives it: grey (scaled to 8 bits below 8)
    repeated, palette images through their colours, alpha dropped, 16 bits
    cut to their high byte."""
    img, depth, color, palette = _read(path)
    if color == 3:
        return palette[img[..., 0]]
    if color == 0 and depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    img = _high_bytes(img)
    if img.shape[2] <= 2:  # grey, grey + alpha
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def read_png_gray(path: str) -> np.ndarray:
    """A PNG as one 8-bit grey channel, as ``cv2.imread(path,
    IMREAD_GRAYSCALE)`` gives it: grey below 8 bits scaled to 8, palette
    images through their colours, alpha dropped, colour through libpng's
    ``rgb_to_gray`` (the weights 9797, 19234, 3737 of 32768: truncated at 8
    bits; at 16 rounded, before the 16 bits are cut to their high byte),
    16 bits cut to their high byte."""
    img, depth, color, palette = _read(path)
    if color == 3:
        img, depth = palette[img[..., 0]], 8
    elif color == 0 and depth < 8:
        return img[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    if img.shape[2] <= 2:  # grey, grey + alpha
        return _high_bytes(np.ascontiguousarray(img[..., 0]))
    rgb = img[..., :3].astype(np.int64)
    gray = sum(c * rgb[..., i] for i, c in enumerate(_GRAY_W))
    if depth == 16:
        return ((gray + 16384) >> 23).astype(np.uint8)
    return (gray >> 15).astype(np.uint8)


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

