"""JPEG decoding and baseline encoding in numpy, without OpenCV or Pillow.

:func:`read_jpeg` decodes a baseline, extended sequential or progressive
Huffman JPEG of 8-bit samples (1, 3 or 4 components, sampling factors 1-4
in integral ratios, restart intervals) as libjpeg-turbo does by default,
and so as ``cv2.imread`` does: the ``islow`` integer IDCT
(``jidctint.c``), upsampling of subsampled components as ``jdsample.c``
chooses it ("fancy" triangle filters for factors of 2, replication for
others, such as 4:1:1's 4), the fixed-point YCbCr to RGB of
``jdcolor.c``, and for 4 components (CMYK, as Pillow writes it) OpenCV's
conversion of inverted CMYK to BGR. It returns BGR like ``cv2.imread``. A
progressive file's scans (DC first and refine, AC first with end-of-band
runs, AC refine: ``jdphuff.c``) fill one coefficient buffer, read whole
before the output is made, as libjpeg-turbo reads a file whole, whose
block smoothing then has no incomplete coefficient to act on.
Arithmetic-coded, lossless, hierarchical, 12-bit and YCCK files raise a
``ValueError`` that names them.

:func:`write_jpeg` encodes baseline 4:2:0 colour with libjpeg's
quality-scaled Annex K quantisation tables and the standard Huffman tables,
quality 95 by default as ``cv2.imwrite`` uses. Its bytes are its own; any
baseline decoder reads them.

Huffman decoding is serial; everything around it is vectorised. The walk
over the symbols uses tables precomputed for every bit position of the
scan (the symbol, its length and the value of its extra bits), so that a
symbol costs a few list lookups.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

# zigzag position -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {
    0xC3: "lossless", 0xC5: "hierarchical sequential",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coef = None  # (blocks_y, blocks_x, 64) natural order
        self.flat = None  # a progressive file's: every block's 64, a list


# -- Huffman ---------------------------------------------------------------

def _huff_codes(bits: List[int], vals: List[int]) -> Tuple[np.ndarray, ...]:
    """Annex C: (code, length, symbol) of a table given BITS and HUFFVAL."""
    codes, lengths, code, k = [], [], 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes.append(code)
            lengths.append(length)
            code += 1
            k += 1
        code <<= 1
    return (np.array(codes, np.int64), np.array(lengths, np.int64),
            np.array(vals[:k], np.int64))


def _huff_lut(bits, vals, is_ac: bool) -> Tuple[np.ndarray, ...]:
    """For every 16-bit window, what the code at its head needs: the shift
    that brings the extra bits of a 32-bit window down, their mask and
    half, and ``symbol << 8 | advance`` (code plus extra bits; 255: no
    code)."""
    codes, lengths, syms = _huff_codes(bits, vals)
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    for c, n, s in zip(codes.tolist(), lengths.tolist(), syms.tolist()):
        lo = c << (16 - n)
        length[lo:lo + (1 << (16 - n))] = n
        sym[lo:lo + (1 << (16 - n))] = s
    size = sym & 15 if is_ac else sym
    mask = (1 << size) - 1
    adv = np.where(length == 0, 255, length + size)
    return 32 - length - size, mask, (mask + 1) >> 1, (sym << 8) | adv


def _bit_table(win: np.ndarray, lut) -> List[int]:
    """For one Huffman table over one entropy-coded segment, at every bit
    position: the symbol decoded there, packed as ``value << 16 | symbol <<
    8 | advance`` (advance: code plus extra bits, 255 for no code; value:
    the signed extra bits)."""
    shift, mask, half, base = (t[win >> 16] for t in lut)
    extra = (win >> shift) & mask
    val = np.where(extra < half, extra - mask, extra)
    return ((val << 16) | base).tolist()


def _windows(data: bytes) -> np.ndarray:
    """The 32 bits starting at every bit position of ``data`` (zeros past
    its end, as libjpeg fills)."""
    b = np.frombuffer(data + bytes(5), np.uint8).astype(np.int64)
    v = ((b[:-4] << 32) | (b[1:-3] << 24) | (b[2:-2] << 16) | (b[3:-1] << 8)
         | b[4:])
    shifts = 8 - np.arange(8)
    return ((v[:, None] >> shifts[None, :]) & 0xFFFFFFFF).reshape(-1)


def _unstuff(seg: bytes) -> bytes:
    return seg.replace(b"\xff\x00", b"\xff")


# -- entropy-coded segments --------------------------------------------------

def _scan_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """Split the entropy-coded data from ``pos`` at its RST markers; return
    the unstuffed segments and the position of the marker that ends it."""
    segs, start, i = [], pos, pos
    n = len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise ValueError("JPEG scan data runs to the end of the file")
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:
            i += 1 if m == 0xFF else 2
            continue
        if 0xD0 <= m <= 0xD7:
            segs.append(_unstuff(data[start:i]))
            start = i = i + 2
            continue
        segs.append(_unstuff(data[start:i]))
        return segs, i


def _decode_blocks(seg: bytes, units, dc_pred: Dict[int, int], tables,
                   out_idx: List[int], out_val: List[int]) -> None:
    """Decode ``units`` ((component index, block index, DC table, AC table)
    in scan order) from one restart interval; append each component's
    natural-order coefficient positions (block index * 64 + k) and values
    to ``out_idx`` / ``out_val``."""
    win = _windows(seg)
    built = {}

    def get(key):
        if key not in built:
            built[key] = _bit_table(win, tables[key])
        return built[key]

    zz = ZIGZAG.tolist()
    pos = 0
    nbits = len(seg) * 8
    for ci, blk, td, ta in units:
        e = get((0, td))[pos]
        adv = e & 255
        if adv == 255:
            raise ValueError("JPEG: bad Huffman code in the DC of a block")
        pred = dc_pred[ci] + (e >> 16)
        dc_pred[ci] = pred
        pos += adv
        base = blk * 64
        idx, val = out_idx[ci], out_val[ci]
        idx.append(base)
        val.append(pred)
        ac = get((1, ta))
        k = 1
        while k < 64:
            e = ac[pos]
            adv = e & 255
            if adv == 255:
                raise ValueError("JPEG: bad Huffman code in the AC of a block")
            pos += adv
            s = (e >> 8) & 255
            if s & 15:
                k += s >> 4
                if k > 63:
                    raise ValueError("JPEG: AC coefficient past 63")
                idx.append(base + zz[k])
                val.append(e >> 16)
                k += 1
            elif s == 0xF0:
                k += 16
            else:
                break
        if pos > nbits + 64:
            raise ValueError("JPEG: scan data ends inside a block")


# -- IDCT (jidctint.c, jpeg_idct_islow) ----------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(s, n: int):
    """One pass of the islow IDCT: ``s`` the 8 inputs (arrays), the outputs
    descaled by ``n`` bits."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 + z3 * -_F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (s[0] + s[4]) << _CONST_BITS
    tmp1 = (s[0] - s[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (n - 1)
    return [(tmp10 + t3 + r) >> n, (tmp11 + t2 + r) >> n,
            (tmp12 + t1 + r) >> n, (tmp13 + t0 + r) >> n,
            (tmp13 - t0 + r) >> n, (tmp12 - t1 + r) >> n,
            (tmp11 - t2 + r) >> n, (tmp10 - t3 + r) >> n]


def _idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(..., 64) natural-order coefficients and a (64,) natural-order table
    -> (..., 8, 8) uint8 samples, bit for bit ``jpeg_idct_islow``."""
    c = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(
        coef.shape[:-1] + (8, 8))
    # pass 1: columns (the inputs down a column are c[..., k, col])
    cols = _idct_1d([c[..., k, :] for k in range(8)],
                    _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, -2)                       # ws[..., k, col]
    rows = _idct_1d([ws[..., :, k] for k in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, -1)                      # out[..., row, k]
    # range_limit[x & 1023]: x + 128 clamped within -512..511, wrapped out
    x = out & 1023
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


# -- upsampling (jdsample.c) and colour (jdcolor.c) -------------------------

def _edge(a: np.ndarray, axis: int, side: int) -> np.ndarray:
    """``a`` shifted by one along ``axis`` with its edge replicated: the
    previous element (side -1) or the next (side +1)."""
    n = a.shape[axis]
    idx = np.clip(np.arange(n) + side, 0, n - 1)
    return np.take(a, idx, axis=axis)


def _upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a component's real samples
    (downsampled height x width) by (rv, rh), as ``jinit_upsampler``
    chooses it: the "fancy" triangle filters for (1, 2), (2, 1) and (2, 2)
    (the last two only past 2 samples a row; else a box), and replication
    for any other integral factors (``int_upsample``: 4:1:1's (1, 4))."""
    x = plane.astype(np.int32)
    dh, dw = x.shape
    if rh == 1 and rv == 1:
        return plane
    if rh > 2 or rv > 2:
        return np.repeat(np.repeat(plane, rv, 0), rh, 1)
    fancy_h = dw > 2
    if rv == 1:  # h2v1
        if not fancy_h:
            return np.repeat(plane, 2, 1)
        even = (3 * x + _edge(x, 1, -1) + 1) >> 2
        odd = (3 * x + _edge(x, 1, 1) + 2) >> 2
        return np.stack([even, odd], -1).reshape(dh, 2 * dw).astype(np.uint8)
    if rh == 1:  # h1v2
        top = (3 * x + _edge(x, 0, -1) + 1) >> 2
        bot = (3 * x + _edge(x, 0, 1) + 2) >> 2
        return np.stack([top, bot], 1).reshape(2 * dh, dw).astype(np.uint8)
    if not fancy_h:  # h2v2 box
        return np.repeat(np.repeat(plane, 2, 0), 2, 1)
    out = []
    for side in (-1, 1):  # the output row above (nearer the row above) / below
        c = 3 * x + _edge(x, 0, side)
        even = (3 * c + _edge(c, 1, -1) + 8) >> 4
        odd = (3 * c + _edge(c, 1, 1) + 7) >> 4
        out.append(np.stack([even, odd], -1).reshape(dh, 2 * dw))
    return np.stack(out, 1).reshape(2 * dh, 2 * dw).astype(np.uint8)


_SCALEBITS = 16
_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + _HALF) >> _SCALEBITS
_CB_B = (_fix(1.77200) * _X + _HALF) >> _SCALEBITS
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + _HALF


def _ycc_to_bgr(y, cb, cr) -> np.ndarray:
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _cmyk_to_bgr(c, m, y, k) -> np.ndarray:
    """OpenCV's CMYK to BGR (``icvCvt_CMYK2BGR_8u_C4C3R``), which reads the
    samples as Adobe's inverted CMYK: each of C, M, Y becomes ``k - (255 -
    v) * k >> 8``."""
    k = k.astype(np.int32)
    return np.stack([k - ((255 - v.astype(np.int32)) * k >> 8)
                     for v in (y, m, c)], -1).astype(np.uint8)


# -- the decoder ---------------------------------------------------------------

def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 BGR, ``cv2.imdecode``'s bits."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    quant: Dict[int, np.ndarray] = {}
    tables: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    comps: List[_Component] = []
    restart = 0
    height = width = 0
    progressive = False
    adobe_transform = None
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m == 0xD9:  # EOI
            break
        if m == 0xD8 or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        seg_len = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + seg_len]
        pos += 2 + seg_len
        if m in _SOF_NAMES:
            raise ValueError(f"JPEG: {_SOF_NAMES[m]} files are not read "
                             "(baseline, extended sequential and progressive "
                             "Huffman only)")
        if m == 0xCC:
            raise ValueError("JPEG: arithmetic coding (DAC marker) is not "
                             "read")
        if m in (0xC0, 0xC1, 0xC2):
            progressive = m == 0xC2
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit samples are not read "
                                 "(8-bit only)")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG: {nc} components are not read "
                                 "(1, 3 or 4)")
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise ValueError(f"JPEG: sampling factors {h}x{v} are not "
                                     "read (1 to 4)")
                comps.append(_Component(cid, h, v, tq))
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if any(hmax % c.h or vmax % c.v for c in comps):
                raise ValueError("JPEG: sampling factors of no integral "
                                 "ratio are not read")
        elif m == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    q = np.frombuffer(body[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    q = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = q
                quant[tq] = nat
        elif m == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                bits = list(body[i + 1:i + 17])
                nv = sum(bits)
                vals = list(body[i + 17:i + 17 + nv])
                tables[(tc, th)] = _huff_lut(bits, vals, tc == 1)
                i += 17 + nv
        elif m == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif m == 0xDA:
            if not comps:
                raise ValueError("JPEG: scan before the frame header")
            pos = (_read_progressive_scan if progressive else _read_scan)(
                data, pos, body, comps, tables, restart, height, width)
    if progressive:
        for c in comps:
            if c.flat is not None:
                c.coef = np.array(c.flat, np.int64).reshape(c.coef.shape)
    if not comps or any(c.coef is None for c in comps):
        raise ValueError("JPEG: no complete image in the file")
    return _finish(comps, quant, height, width, adobe_transform)


def _geometry(comps, height, width):
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    return hmax, vmax, mcux, mcuy


def _scan_selectors(body, comps):
    """A scan header's (component index, DC table, AC table) per component
    and its (Ss, Se, Ah, Al)."""
    ns = body[0]
    ids = [c.id for c in comps]
    sel = []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in ids:
            raise ValueError(f"JPEG: a scan names component {cid}, which "
                             "the frame does not define")
        sel.append((ids.index(cid), t >> 4, t & 15))
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    return sel, (ss, se, ahal >> 4, ahal & 15)


def _need_tables(keys, tables):
    for key in keys:
        if key not in tables:
            raise ValueError("JPEG: a scan names a Huffman table the file "
                             "does not define")


def _scan_units(cis, comps, height, width):
    """The blocks a scan of the components ``cis`` codes, in its order, as
    (component index, block index in the component's MCU-padded grid), and
    the blocks of one MCU (of one restart unit): one component's own blocks
    row by row; several components' blocks MCU by MCU. Allocates each
    component's coefficients at its first scan."""
    hmax, vmax, mcux, mcuy = _geometry(comps, height, width)
    for ci in cis:
        c = comps[ci]
        if c.coef is None:
            c.coef = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int64)
    units = []
    if len(cis) == 1:
        c = comps[cis[0]]
        # the component's own blocks: ceil(ceil(size * factor / max) / 8)
        bw = -(-(-(-width * c.h // hmax)) // 8)
        bh = -(-(-(-height * c.v // vmax)) // 8)
        gw = c.coef.shape[1]
        units = [(cis[0], by * gw + bx) for by in range(bh)
                 for bx in range(bw)]
        return units, 1
    for my in range(mcuy):
        for mx in range(mcux):
            for ci in cis:
                c = comps[ci]
                gw = c.coef.shape[1]
                for v in range(c.v):
                    for h in range(c.h):
                        units.append((ci, (my * c.v + v) * gw + mx * c.h + h))
    return units, sum(comps[ci].h * comps[ci].v for ci in cis)


def _read_scan(data, pos, body, comps, tables, restart, height, width):
    sel, band = _scan_selectors(body, comps)
    _need_tables([k for _, td, ta in sel for k in ((0, td), (1, ta))],
                 tables)
    if band != (0, 63, 0, 0):
        raise ValueError("JPEG: spectral selection or successive "
                         "approximation in a sequential scan")
    tabs = {ci: (td, ta) for ci, td, ta in sel}
    units, per_mcu = _scan_units([ci for ci, _, _ in sel], comps, height,
                                 width)
    units = [(ci, blk, *tabs[ci]) for ci, blk in units]
    segs, end = _scan_segments(data, pos)
    chunk = restart * per_mcu if restart else len(units)
    out_idx = {ci: [] for ci, _, _ in sel}
    out_val = {ci: [] for ci, _, _ in sel}
    for s, start in enumerate(range(0, len(units), chunk)):
        if s >= len(segs):
            raise ValueError("JPEG: fewer restart intervals than the image "
                             "needs")
        _decode_blocks(segs[s], units[start:start + chunk],
                       {ci: 0 for ci, _, _ in sel}, tables, out_idx, out_val)
    for ci, _, _ in sel:
        flat = comps[ci].coef.reshape(-1)
        flat[np.array(out_idx[ci], np.int64)] = np.array(out_val[ci],
                                                         np.int64)
    return end


def _read_progressive_scan(data, pos, body, comps, tables, restart, height,
                           width):
    """One scan of a progressive file into the components' coefficient
    lists (``jdphuff.c``): a DC scan (Ss = Se = 0) of one or several
    components, first (Ah = 0) or refining (one bit a block), or an AC scan
    of one component over the band Ss..Se, first or refining."""
    sel, (ss, se, ah, al) = _scan_selectors(body, comps)
    if (ss == 0) != (se == 0) or ss > se or se > 63 or al > 13 or (
            ss and len(sel) != 1):
        raise ValueError(f"JPEG: a progressive scan with the band "
                         f"{ss}..{se} over {len(sel)} components (Al {al})")
    if ss == 0:
        keys = [] if ah else [(0, td) for _, td, _ in sel]
    else:
        keys = [(1, sel[0][2])]
    _need_tables(keys, tables)
    units, per_mcu = _scan_units([ci for ci, _, _ in sel], comps, height,
                                 width)
    for ci, _, _ in sel:
        c = comps[ci]
        if c.flat is None:
            c.flat = [0] * c.coef.size
    segs, end = _scan_segments(data, pos)
    chunk = restart * per_mcu if restart else len(units)
    dc = {ci: td for ci, td, _ in sel}
    for s, start in enumerate(range(0, len(units), chunk)):
        if s >= len(segs):
            raise ValueError("JPEG: fewer restart intervals than the image "
                             "needs")
        seg = segs[s]
        block = units[start:start + chunk]
        if ss == 0:
            _decode_dc_scan(seg, block, comps, dc, ah, al, tables)
        else:
            win = _windows(seg)
            (_decode_ac_refine if ah else _decode_ac_first)(
                _bit_table(win, tables[keys[0]]), win.tolist(),
                len(seg) * 8, [blk for _, blk in block],
                comps[sel[0][0]].flat, ss, se, al)
    return end


def _decode_dc_scan(seg, units, comps, dc, ah, al, tables):
    """A progressive DC scan over one restart interval: the first (each
    block's DC difference, coded as in a sequential scan, scaled by 2^Al)
    or a refinement (one bit a block, set at 2^Al)."""
    if ah:
        bits = _windows(seg).tolist()
        for pos, (ci, blk) in enumerate(units):
            if bits[pos] >> 31:
                comps[ci].flat[blk * 64] |= 1 << al
        return
    win = _windows(seg)
    tabs = {td: _bit_table(win, tables[(0, td)]) for td in set(dc.values())}
    pred = {ci: 0 for ci in dc}
    pos = 0
    for ci, blk in units:
        e = tabs[dc[ci]][pos]
        if e & 255 == 255:
            raise ValueError("JPEG: bad Huffman code in the DC of a block")
        pos += e & 255
        pred[ci] += e >> 16
        comps[ci].flat[blk * 64] = pred[ci] * (1 << al)
    if pos > len(seg) * 8 + 64:
        raise ValueError("JPEG: scan data ends inside a block")


def _eob_run(bits, pos, r):
    """An end-of-band run of 2^r + the r bits at ``pos`` blocks."""
    return (1 << r) + ((bits[pos] >> (32 - r)) & ((1 << r) - 1) if r else 0)


def _decode_ac_first(tab, bits, nbits, blks, flat, ss, se, al):
    """A first AC scan of one component over one restart interval: each
    block's coefficients Ss..Se, scaled by 2^Al, or a run of blocks that
    end before the band (EOBRUN)."""
    zz = ZIGZAG.tolist()
    pos = eobrun = 0
    for blk in blks:
        if eobrun:
            eobrun -= 1
            continue
        base = blk * 64
        k = ss
        while k <= se:
            e = tab[pos]
            adv = e & 255
            if adv == 255:
                raise ValueError("JPEG: bad Huffman code in the AC of a block")
            pos += adv
            r, s = (e >> 12) & 15, (e >> 8) & 15
            if s:
                k += r
                if k > se:
                    raise ValueError("JPEG: AC coefficient past the band")
                flat[base + zz[k]] = (e >> 16) * (1 << al)
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = _eob_run(bits, pos, r) - 1
                pos += r
                break
    if pos > nbits + 64:
        raise ValueError("JPEG: scan data ends inside a block")


def _decode_ac_refine(tab, bits, nbits, blks, flat, ss, se, al):
    """An AC refinement scan of one component over one restart interval:
    in each block, coefficients Ss..Se that were 0 become ±2^Al where the
    scan says, and every one already nonzero takes a correction bit (its
    magnitude grows by 2^Al where the bit is 1 and that bit is still
    clear); blocks of an end-of-band run take correction bits only."""
    zz = ZIGZAG.tolist()
    p1 = 1 << al
    pos = eobrun = 0
    for blk in blks:
        base = blk * 64
        k = ss
        if not eobrun:
            while k <= se:
                e = tab[pos]
                adv = e & 255
                if adv == 255:
                    raise ValueError("JPEG: bad Huffman code in the AC of a "
                                     "block")
                pos += adv
                r, s = (e >> 12) & 15, (e >> 8) & 15
                new = 0
                if s:  # its sign bit, read with the code: ±1
                    new = p1 if e >> 16 > 0 else -p1
                elif r != 15:
                    eobrun = _eob_run(bits, pos, r)
                    pos += r
                    break
                # past coefficients already nonzero (each a correction bit)
                # and r that are still 0, to the one that becomes nonzero
                while k <= se:
                    z = base + zz[k]
                    cur = flat[z]
                    if cur:
                        if bits[pos] >> 31 and not cur & p1:
                            flat[z] = cur + p1 if cur >= 0 else cur - p1
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if new:
                    if k > se:
                        raise ValueError("JPEG: AC coefficient past the band")
                    flat[base + zz[k]] = new
                k += 1
        if eobrun:
            while k <= se:
                z = base + zz[k]
                cur = flat[z]
                if cur:
                    if bits[pos] >> 31 and not cur & p1:
                        flat[z] = cur + p1 if cur >= 0 else cur - p1
                    pos += 1
                k += 1
            eobrun -= 1
    if pos > nbits + 64:
        raise ValueError("JPEG: scan data ends inside a block")


def _finish(comps, quant, height, width, adobe_transform):
    hmax, vmax, _, _ = _geometry(comps, height, width)
    planes = []
    for c in comps:
        if c.tq not in quant:
            raise ValueError(f"JPEG: quantisation table {c.tq} is missing")
        px = _idct_islow(c.coef, quant[c.tq])      # (by, bx, 8, 8)
        by, bx = px.shape[:2]
        plane = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        dh = -(-height * c.v // vmax)
        dw = -(-width * c.h // hmax)
        up = _upsample(plane[:dh, :dw], hmax // c.h, vmax // c.v)
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, -1)
    if len(planes) == 4:
        # libjpeg reads 4 components as CMYK unless an Adobe marker says
        # they were transformed (YCCK)
        if adobe_transform not in (None, 0):
            raise ValueError("JPEG: YCCK files are not read (CMYK only)")
        return _cmyk_to_bgr(*planes)
    ids = tuple(c.id for c in comps)
    if adobe_transform == 0 or ids == (82, 71, 66):  # stored as RGB
        return np.stack(planes[::-1], -1)
    return _ycc_to_bgr(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a JPEG: (H, W, 3) uint8 BGR."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


# -- the encoder ---------------------------------------------------------------

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])
# Annex K.3 (BITS, HUFFVAL)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], list(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")))


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality``: the Annex K tables scaled, baseline
    (1..255), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2)
    return m


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) padded by edge replication to whole blocks -> (by, bx, 8, 8)."""
    h, w = plane.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    p = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
    return p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)


def _quantise(blocks: np.ndarray, table: np.ndarray) -> np.ndarray:
    """float DCT of level-shifted samples, divided by the table and rounded
    half away from zero -> (..., 64) zigzag-ordered int coefficients."""
    x = blocks.astype(np.float64) - 128.0
    coef = _DCT @ x @ _DCT.T
    q = coef.reshape(coef.shape[:-2] + (64,)) / table
    q = np.sign(q) * np.floor(np.abs(q) + 0.5)
    return q[..., ZIGZAG].astype(np.int64)


def _bit_size(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _code_map(spec) -> Tuple[np.ndarray, np.ndarray]:
    codes, lengths, syms = _huff_codes(*spec)
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    code[syms] = codes
    length[syms] = lengths
    return code, length


def _encode_units(coefs: np.ndarray, dc_spec, ac_spec, order: np.ndarray):
    """Huffman items (value, bit length, sort key) for the blocks
    ``coefs`` (n, 64) zigzag, whose scan positions are ``order`` (n,)."""
    dc_code, dc_len = _code_map(dc_spec)
    ac_code, ac_len = _code_map(ac_spec)
    n = len(coefs)
    items_v, items_l, items_k = [], [], []
    # DC: differences along the scan order
    dc = coefs[:, 0]
    rank = np.argsort(order, kind="stable")
    diff = np.empty(n, np.int64)
    diff[rank] = np.diff(np.concatenate([[0], dc[rank]]))
    size = _bit_size(diff)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << size) - 1)
    items_v.append((dc_code[size] << size) | extra)
    items_l.append(dc_len[size] + size)
    items_k.append(order * 1024)
    # AC (keys within a block: DC 0, the z-th ZRL before coefficient k at
    # 8k + z, its code at 8k + 4, EOB at 1000): each nonzero coefficient after a run of zeros (ZRLs for runs > 15)
    ac = coefs[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    prev = np.concatenate([[0], k[:-1]])
    first = np.concatenate([[True], b[1:] != b[:-1]])
    run = k - np.where(first, 0, prev) - 1
    val = ac[b, k - 1]
    size = _bit_size(val)
    extra = np.where(val < 0, val - 1, val) & ((1 << size) - 1)
    sym = ((run & 15) << 4) | size
    items_v.append((ac_code[sym] << size) | extra)
    items_l.append(ac_len[sym] + size)
    items_k.append(order[b] * 1024 + k * 8 + 4)
    for z in range(1, 4):
        zb = run >= 16 * z
        items_v.append(np.full(zb.sum(), ac_code[0xF0]))
        items_l.append(np.full(zb.sum(), ac_len[0xF0]))
        items_k.append(order[b[zb]] * 1024 + k[zb] * 8 + z)
    # EOB after the last nonzero coefficient unless it is the 63rd
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = last < 63
    items_v.append(np.full(eob.sum(), ac_code[0x00]))
    items_l.append(np.full(eob.sum(), ac_len[0x00]))
    items_k.append(order[eob] * 1024 + 1000)
    return items_v, items_l, items_k


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    owner = np.repeat(np.arange(len(lengths)), lengths)
    j = np.arange(total) - starts[owner]
    bits = (values[owner] >> (lengths[owner] - 1 - j)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's fixed-point RGB -> YCbCr."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    cb_off = (128 << _SCALEBITS) + _HALF - 1
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + _HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + cb_off) >> _SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + cb_off) >> _SCALEBITS
    return y, cb, cr


def _downsample2(plane: np.ndarray, h2: int, w2: int) -> np.ndarray:
    """jcsample.c's h2v2 downsampling (edge replicated), bias 1, 2, 1, 2."""
    p = np.pad(plane, ((0, 2 * h2 - plane.shape[0]),
                       (0, 2 * w2 - plane.shape[1])), mode="edge")
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.tile([1, 2], -(-w2 // 2))[:w2]
    return (s + bias) >> 2


def encode_jpeg(bgr: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR (as ``cv2.imwrite`` takes) -> baseline JPEG
    bytes, 4:2:0."""
    img = np.asarray(bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    lq, cq = quality_tables(quality)
    y, cb, cr = _rgb_to_ycc(img[..., ::-1])
    mcux, mcuy = -(-w // 16), -(-h // 16)
    planes = [(np.pad(y, ((0, 16 * mcuy - h), (0, 16 * mcux - w)),
                      mode="edge"), 2)]
    for c in (cb, cr):
        planes.append((_downsample2(c, 8 * mcuy, 8 * mcux), 1))
    vals, lens, keys = [], [], []
    for ci, (plane, f) in enumerate(planes):
        blocks = _blocks(plane)                         # (by, bx, 8, 8)
        coef = _quantise(blocks, lq if ci == 0 else cq)
        by, bx = coef.shape[:2]
        yy, xx = np.meshgrid(np.arange(by), np.arange(bx), indexing="ij")
        # scan position: MCU index, then this component's slot in the MCU
        # (Y's 2x2 blocks in slots 0-3, Cb 4, Cr 5)
        mcu = (yy // f) * mcux + xx // f
        slot = (yy % f) * f + xx % f if ci == 0 else 3 + ci
        order = (mcu * 6 + slot).reshape(-1)
        spec = ((_DC_LUMA, _AC_LUMA) if ci == 0
                else (_DC_CHROMA, _AC_CHROMA))
        v, l_, k = _encode_units(coef.reshape(-1, 64), *spec, order)
        vals += v
        lens += l_
        keys += k
    keys = np.concatenate(keys)
    sort = np.argsort(keys, kind="stable")
    scan = _pack(np.concatenate(vals)[sort], np.concatenate(lens)[sort])
    return _headers(h, w, lq, cq) + scan + b"\xff\xd9"


def _marker(m: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, m, len(body) + 2) + body


def _dht(tc: int, th: int, spec) -> bytes:
    bits, vals = spec
    return bytes([tc << 4 | th]) + bytes(bits) + bytes(vals)


def _headers(h, w, lq, cq) -> bytes:
    qt = (bytes([0]) + lq[ZIGZAG].astype(np.uint8).tobytes() + bytes([1])
          + cq[ZIGZAG].astype(np.uint8).tobytes())
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = (_dht(0, 0, _DC_LUMA) + _dht(1, 0, _AC_LUMA)
           + _dht(0, 1, _DC_CHROMA) + _dht(1, 1, _AC_CHROMA))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return b"".join([
        b"\xff\xd8",
        _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _marker(0xDB, qt), _marker(0xC0, sof), _marker(0xC4, dht),
        _marker(0xDA, sos)])


def write_jpeg(path: str, bgr: np.ndarray, quality: int = 95) -> None:
    """``cv2.imwrite(path, bgr)`` for a ``.jpg`` (quality 95)."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(bgr, quality))
