"""OpenEXR image reader (no external EXR dependency; the port's copy of
``implicit_depth_tpu/data/exr.py``).

Replaces the reference's ``exr_loader`` (src/utils/data_augmentation.py:16-53,
which requires the OpenEXR C++ bindings). Supports single-part scanline EXR
v2 files with NONE / RLE / ZIPS / ZIP compression and HALF / FLOAT / UINT
channels — covering the ClearGrasp depth (single 'R' float) and RGB files.

Decoding is vectorized numpy: the EXR byte predictor is a cumulative sum and
the two-half byte interleave is a reshape, so ZIP blocks decode at memory
speed after zlib. If the native C++ runtime (native/) is built, its decoder
is used for the zlib+reorder stage instead.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from implicit_depth_torch import native

_MAGIC = 20000630
_PXTYPE_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16}  # NONE, RLE, ZIPS, ZIP


class ExrError(ValueError):
    pass


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes) -> List[Dict]:
    out, off = [], 0
    while data[off] != 0:
        name, off = _read_cstr(data, off)
        ptype, _plinear, xs, ys = struct.unpack_from("<iBxxxii", data, off)
        off += 16
        out.append({"name": name, "ptype": ptype, "xs": xs, "ys": ys})
    return out


def _predictor_uninterleave(raw: bytes) -> np.ndarray:
    """Invert the EXR 'deflate helper': delta predictor then two-half
    byte interleave."""
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    arr = (np.cumsum(arr - 128) + 128) % 256
    n = len(arr)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:half + n // 2]
    return out


def _rle_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        cnt = struct.unpack_from("<b", data, i)[0]
        i += 1
        if cnt < 0:
            out += data[i:i - cnt]
            i += -cnt
        else:
            out += data[i:i + 1] * (cnt + 1)
            i += 1
    return bytes(out)


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read an EXR file -> {channel_name: (H, W) float32/uint32 array}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ExrError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ExrError(f"{path}: tiled EXR not supported")
    if version & 0x1000:
        raise ExrError(f"{path}: multi-part EXR not supported")

    # header attributes
    off = 8
    attrs: Dict[str, bytes] = {}
    while buf[off] != 0:
        name, off = _read_cstr(buf, off)
        _atype, off = _read_cstr(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        attrs[name] = buf[off:off + size]
        off += size
    off += 1

    channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in _LINES_PER_BLOCK:
        raise ExrError(f"{path}: compression {compression} not supported "
                       "(NONE/RLE/ZIPS/ZIP only)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = -(-h // lpb)
    off += 8 * n_blocks  # skip offset table; chunks follow in order

    # bytes per scanline per channel and per full line
    ch_sizes = [np.dtype(_PXTYPE_DTYPE[c["ptype"]]).itemsize * w for c in channels]
    line_size = sum(ch_sizes)

    out = {c["name"]: np.empty((h, w), _PXTYPE_DTYPE[c["ptype"]]) for c in channels}

    for _ in range(n_blocks):
        y, dsize = struct.unpack_from("<ii", buf, off)
        off += 8
        data = buf[off:off + dsize]
        off += dsize
        rows = min(lpb, y1 - y + 1)
        expect = line_size * rows
        if compression == 0 or dsize == expect:  # NONE or incompressible
            block = np.frombuffer(data, np.uint8)
        elif compression == 1:  # RLE
            block = native.exr_unrle(data, expect)
            if block is None:
                block = _predictor_uninterleave(_rle_decode(data))
        else:  # ZIPS / ZIP
            block = native.exr_unzip(data, expect)
            if block is None:
                block = _predictor_uninterleave(zlib.decompress(data))
        block = block[:expect].reshape(rows, line_size)
        col = 0
        for c, csz in zip(channels, ch_sizes):
            rowdata = block[:, col:col + csz].copy().view(_PXTYPE_DTYPE[c["ptype"]])
            out[c["name"]][y - y0:y - y0 + rows] = rowdata.reshape(rows, w)
            col += csz
    return {k: (v.astype(np.float32) if v.dtype == np.float16 else v)
            for k, v in out.items()}


def exr_loader(path: str, ndim: int = 3) -> np.ndarray:
    """Reference-compatible facade (data_augmentation.py:16): ndim=1 returns
    the 'R' channel (H, W); ndim=3 stacks R, G, B into (3, H, W)."""
    chans = read_exr(path)
    if ndim == 1:
        key = "R" if "R" in chans else next(iter(chans))
        return chans[key].astype(np.float32)
    return np.stack([chans[c] for c in ("R", "G", "B")], 0).astype(np.float32)


def write_exr(path: str, channels: Dict[str, np.ndarray],
              compression: int = 3) -> None:
    """Minimal EXR writer (ZIP), for tests and visualization round-trips."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    ch_entries = b""
    for n in names:
        ch_entries += n.encode() + b"\0" + struct.pack("<iBxxxii", 2, 0, 1, 1)
    ch_entries += b"\0"

    def attr(name: str, atype: str, data: bytes) -> bytes:
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", _MAGIC, 2)
              + attr("channels", "chlist", ch_entries)
              + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = -(-h // lpb)
    chunks = []
    for b in range(n_blocks):
        y = b * lpb
        rows = min(lpb, h - y)
        lines = []
        for r in range(rows):
            for n in names:
                lines.append(channels[n][y + r].astype(np.float32).tobytes())
        raw = b"".join(lines)
        if compression in (2, 3):
            arr = np.frombuffer(raw, np.uint8)
            n_ = len(arr)
            half = (n_ + 1) // 2
            inter = np.concatenate([arr[0::2], arr[1::2]])
            delta = np.empty(n_, np.int64)
            delta[0] = inter[0]
            delta[1:] = (inter[1:].astype(np.int64) - inter[:-1].astype(np.int64) + 128)
            payload = zlib.compress((delta % 256).astype(np.uint8).tobytes())
            if len(payload) >= len(raw):
                payload = raw
        else:
            payload = raw
        chunks.append(struct.pack("<ii", y, len(payload)) + payload)

    offsets = []
    base = len(header) + 8 * n_blocks
    pos = base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header)
        for o in offsets:
            f.write(struct.pack("<Q", o))
        for c in chunks:
            f.write(c)
