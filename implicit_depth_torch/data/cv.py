"""numpy twins of the OpenCV calls the data path and serving make, so that
the port reads and augments the disk datasets without OpenCV.

Each twin follows the arithmetic of OpenCV's own code (``imgproc``'s
``resize.cpp``, ``color_hsv.simd.hpp``, ``filter.simd.hpp``,
``drawing.cpp``) step by step, in the same precision and, where it matters,
in the order of its vector code, so that the result is OpenCV's bits:

- :func:`resize`: ``INTER_NEAREST`` (any dtype), ``INTER_LINEAR`` on uint8
  (11-bit fixed-point weights; an exact 2x shrink is OpenCV's area
  average) and float32, ``INTER_CUBIC`` on float32. OpenCV hands the float
  ``INTER_LINEAR`` and ``INTER_CUBIC`` resizes to Intel IPP where its build
  has it; IPP's own arithmetic is not reproduced, and those two differ
  from such a build by a few float32 ulps (the tests state the bound).
- :func:`bgr_to_rgb`, :func:`rgb_to_bgr`;
- :func:`bgr_to_hls`, :func:`hls_to_bgr` on uint8 (hue in [0, 180));
- :func:`filter2d`: uint8 with a float kernel, ``BORDER_REFLECT_101``;
- :func:`fill_ellipse`: ``cv2.ellipse(..., thickness=-1)``, 8-connected.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC = 0, 1, 2

_F32 = np.float32
_COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
# OpenCV's vector loops: 4 float lanes in the resize (the baseline SSE
# build of resize.cpp), 8 in the colour conversions (their AVX2 dispatch)
_RESIZE_LANES = 4
_HLS_LANES = 8


def _fma(a, b, c) -> np.ndarray:
    """float32 a*b + c rounded once (a fused multiply-add)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _src_coords(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``fx = (float)((dx + 0.5) * scale - 0.5)``, ``sx =
    floor(fx)``, ``fx -= sx``, scale the double ``1 / (dst / src)``."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(_F32)).astype(_F32)


def _bcast(v: np.ndarray, ndim: int, axis: int) -> np.ndarray:
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def _resize_nearest(img, h, w):
    src_h, src_w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / src_h))).astype(
        np.int64), src_h - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / src_w))).astype(
        np.int64), src_w - 1)
    return img[ys][:, xs]


def _linear_coefs(dst, src, clamp):
    s, f = _src_coords(dst, src)
    if clamp:  # x only: OpenCV clamps the x taps, and clips the y rows
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0
        s[lo], s[hi] = 0, src - 1
    return s, (_F32(1) - f).astype(_F32), f


def _resize_area2(img):
    """OpenCV's INTER_LINEAR at exactly half size: the 2x2 area mean."""
    a, b = img[0::2, 0::2], img[0::2, 1::2]
    c, d = img[1::2, 0::2], img[1::2, 1::2]
    if img.dtype == np.uint8:
        s = (a.astype(np.int32) + b + c + d + 2) >> 2
        return s.astype(np.uint8)
    # float32: the vector code adds the two rows' pairs, (a + b) + (c + d),
    # for one channel (4 pixels a vector, the rest of a row one by one) and
    # four; the scalar code adds in order
    seq = ((((a + b) + c) + d) * _F32(0.25)).astype(_F32)
    pair = (((a + b) + (c + d)) * _F32(0.25)).astype(_F32)
    cn = 1 if img.ndim == 2 else img.shape[2]
    if cn == 4:
        return pair
    if cn == 1:
        tail = (pair.shape[1] // _RESIZE_LANES) * _RESIZE_LANES
        pair[:, tail:] = seq[:, tail:]
        return pair
    return seq


def _resize_linear(img, h, w):
    src_h, src_w = img.shape[:2]
    if 2 * h == src_h and 2 * w == src_w:
        return _resize_area2(img)
    sx, a0, a1 = _linear_coefs(w, src_w, True)
    sy, b0, b1 = _linear_coefs(h, src_h, False)
    sx1 = np.minimum(sx + 1, src_w - 1)
    y0, y1 = np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1)
    nd = img.ndim
    if img.dtype == np.uint8:
        ia0, ia1 = (np.rint(c * _F32(_COEF_SCALE)).astype(np.int64)
                    for c in (a0, a1))
        ib0, ib1 = (np.rint(c * _F32(_COEF_SCALE)).astype(np.int64)
                    for c in (b0, b1))
        x = img.astype(np.int64)
        rows = x[:, sx] * _bcast(ia0, nd, 1) + x[:, sx1] * _bcast(ia1, nd, 1)
        # VResizeLinearVec_32s8u: rows >> 4 packed to int16, multiplied
        # by the weight keeping the high 16 bits, summed, rounded by 2 bits
        r0, r1 = rows[y0] >> 4, rows[y1] >> 4
        out = (((r0 * _bcast(ib0, nd, 0)) >> 16)
               + ((r1 * _bcast(ib1, nd, 0)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    x = img.astype(_F32)
    rows = (x[:, sx] * _bcast(a0, nd, 1) + x[:, sx1] * _bcast(a1, nd, 1))
    return (rows[y0] * _bcast(b0, nd, 0)
            + rows[y1] * _bcast(b1, nd, 0)).astype(_F32)


def _cubic_coefs(x: np.ndarray):
    """OpenCV's ``interpolateCubic`` in float32, A = -0.75."""
    a, one = _F32(-0.75), _F32(1)
    x1 = (x + one).astype(_F32)
    c0 = (((a * x1 - _F32(5) * a) * x1 + _F32(8) * a) * x1
          - _F32(4) * a).astype(_F32)
    c1 = (((a + _F32(2)) * x - (a + _F32(3))) * x * x + one).astype(_F32)
    y = (one - x).astype(_F32)
    c2 = (((a + _F32(2)) * y - (a + _F32(3))) * y * y + one).astype(_F32)
    c3 = (((one - c0) - c1) - c2).astype(_F32)
    return c0, c1, c2, c3


def _resize_cubic(img, h, w):
    if img.dtype != np.float32:
        raise ValueError(f"INTER_CUBIC takes float32, not {img.dtype}")
    src_h, src_w = img.shape[:2]
    nd = img.ndim
    sx, fx = _src_coords(w, src_w)
    sy, fy = _src_coords(h, src_h)
    a = [_bcast(c, nd, 1) for c in _cubic_coefs(fx)]
    b = [_bcast(c, nd, 0) for c in _cubic_coefs(fy)]
    # the horizontal pass sums its four taps in order
    rows = None
    for k in range(4):
        t = img[:, np.clip(sx - 1 + k, 0, src_w - 1)] * a[k]
        rows = t if rows is None else (rows + t).astype(_F32)
    taps = [rows[np.clip(sy - 1 + k, 0, src_h - 1)] for k in range(4)]
    # the vertical pass: VResizeCubicVec_32f sums from the last tap to the
    # first (b3*S3, then + b2*S2, + b1*S1, + b0*S0) over whole vectors of a
    # row; the scalar tail sums in order
    rev = taps[3] * b[3]
    for k in (2, 1, 0):
        rev = (taps[k] * b[k] + rev).astype(_F32)
    fwd = taps[0] * b[0]
    for k in (1, 2, 3):
        fwd = (fwd + taps[k] * b[k]).astype(_F32)
    out = rev.reshape(h, -1)
    n = out.shape[1]
    tail = (n // _RESIZE_LANES) * _RESIZE_LANES
    out[:, tail:] = fwd.reshape(h, -1)[:, tail:]
    return out.reshape(rev.shape)


def resize(img: np.ndarray, wh: Tuple[int, int],
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, wh, interpolation=...)``: (H, W[, C]) to (h, w[,
    C]) with ``wh = (w, h)``; one channel comes back (h, w), as cv2 gives
    it."""
    img = np.ascontiguousarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    w, h = int(wh[0]), int(wh[1])
    if img.ndim not in (2, 3) or w <= 0 or h <= 0:
        raise ValueError(f"resize: (H, W[, C]) image to a positive size, "
                         f"not {img.shape} to {wh}")
    if (h, w) == img.shape[:2]:
        return img.copy()
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, h, w)
    if interpolation == INTER_LINEAR:
        if img.dtype not in (np.uint8, np.float32):
            raise ValueError(f"INTER_LINEAR takes uint8 or float32, not "
                             f"{img.dtype}")
        return _resize_linear(img, h, w)
    if interpolation == INTER_CUBIC:
        return _resize_cubic(img, h, w)
    raise ValueError(f"interpolation {interpolation}: INTER_NEAREST, "
                     "INTER_LINEAR or INTER_CUBIC")


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2RGB)`` (and RGB2BGR: the same swap)."""
    return np.ascontiguousarray(img[..., ::-1])


rgb_to_bgr = bgr_to_rgb


def _per_lane(simd: np.ndarray, scalar: np.ndarray) -> np.ndarray:
    """OpenCV's colour loops run a row's pixels in vectors of
    ``_HLS_LANES`` and the rest one by one: pick each pixel's result."""
    w = simd.shape[1]
    tail = (w // _HLS_LANES) * _HLS_LANES
    out = simd.copy()
    out[:, tail:] = scalar[:, tail:]
    return out


def bgr_to_hls(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2HLS)`` on uint8: H in [0, 180)."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"bgr_to_hls takes (H, W, 3) uint8, not "
                         f"{bgr.shape} {bgr.dtype}")
    inv = _F32(1.0 / 255.0)
    b, g, r = (bgr[..., i].astype(_F32) * inv for i in range(3))
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = (vmax - vmin).astype(_F32)
    vsum = (vmax + vmin).astype(_F32)
    lum = (vsum * _F32(0.5)).astype(_F32)
    r_max, g_max = vmax == r, vmax == g
    with np.errstate(divide="ignore", invalid="ignore"):
        rev = (_F32(60) / diff).astype(_F32)
        # vector code: one select for the difference and one for the offset
        # (360 where r is the max and g < b), then a fused multiply-add
        s_v = (diff / np.where(lum < _F32(0.5), vsum,
                               _F32(2) - vsum)).astype(_F32)
        d = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
        off = np.where(r_max, np.where(g < b, _F32(360), _F32(0)),
                       np.where(g_max, _F32(120), _F32(240)))
        h_v = (_fma(d, rev, off) * _F32(0.5)).astype(_F32)
        # scalar code (a row's tail), as compiled with contraction
        s_s = np.where(lum < _F32(0.5), diff / vsum,
                       diff / ((_F32(2) - vmax) - vmin)).astype(_F32)
        h_s = np.where(r_max, ((g - b) * rev).astype(_F32),
                       np.where(g_max, _fma(b - r, rev, _F32(120)),
                                _fma(r - g, rev, _F32(240))))
        h_s = (np.where(h_s < 0, h_s + _F32(360), h_s) * _F32(0.5)).astype(
            _F32)
    chroma = diff > np.finfo(_F32).eps
    hue = np.where(chroma, _per_lane(h_v, h_s), _F32(0))
    sat = np.where(chroma, _per_lane(s_v, s_s), _F32(0))
    out = np.stack([hue, lum * _F32(255), sat * _F32(255)], -1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


_HLS_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def hls_to_bgr(hls: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hls, COLOR_HLS2BGR)`` on uint8 (H in degrees / 2)."""
    if hls.dtype != np.uint8 or hls.ndim != 3 or hls.shape[2] != 3:
        raise ValueError(f"hls_to_bgr takes (H, W, 3) uint8, not "
                         f"{hls.shape} {hls.dtype}")
    inv = _F32(1.0 / 255.0)
    hue = hls[..., 0].astype(_F32) * (_F32(6) / _F32(180))
    lum = hls[..., 1].astype(_F32) * inv
    sat = hls[..., 2].astype(_F32) * inv
    p2 = np.where(lum <= _F32(0.5), lum * (_F32(1) + sat),
                  (lum + sat) - lum * sat).astype(_F32)
    p1 = (_F32(2) * lum - p2).astype(_F32)
    hue = np.mod(hue, _F32(6)).astype(_F32)
    sector = np.floor(hue).astype(np.int64)
    frac = (hue - sector.astype(_F32)).astype(_F32)
    tab = [p2, p1, (p1 + (p2 - p1) * (_F32(1) - frac)).astype(_F32),
           (p1 + (p2 - p1) * frac).astype(_F32)]
    out = [np.choose(_HLS_SECTORS[sector, k], tab) for k in range(3)]
    out = np.stack([np.where(sat == 0, lum, o) for o in out], -1)
    return np.clip(np.rint(out * _F32(255)), 0, 255).astype(np.uint8)


def _reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Source indices of positions -lo .. n-1+hi under BORDER_REFLECT_101."""
    idx = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` on uint8 with a float kernel, the
    anchor at its centre and ``BORDER_REFLECT_101``: each output is the
    float32 sum over the kernel's nonzero taps in row-major order, rounded
    half to even."""
    if img.dtype != np.uint8:
        raise ValueError(f"filter2d takes uint8, not {img.dtype}")
    k = np.asarray(kernel, _F32)
    kh, kw = k.shape
    ay, ax = kh // 2, kw // 2
    src = img.astype(_F32)
    rows = _reflect101(img.shape[0], ay, kh - 1 - ay)
    cols = _reflect101(img.shape[1], ax, kw - 1 - ax)
    pad = src[rows][:, cols]
    h, w = img.shape[:2]
    acc = np.zeros(src.shape, _F32)
    for i, j in zip(*np.nonzero(k)):
        acc = (acc + pad[i:i + h, j:j + w] * k[i, j]).astype(_F32)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


# drawing.cpp's SinTable: sin of 0..450 degrees, rounded to 7 decimals
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(_F32)
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _ellipse_poly(center, axes, angle: int, delta: int):
    """``ellipse2Poly`` (double version) for the full arc, in XY_SHIFT
    fixed point, as ``EllipseEx`` rounds it (consecutive duplicates
    dropped)."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha = float(_SIN_TABLE[450 - angle])
    beta = float(_SIN_TABLE[angle])
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = axes[0] * float(_SIN_TABLE[450 - a])
        y = axes[1] * float(_SIN_TABLE[a])
        pts.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
    out = []
    for px, py in pts:
        # cvRound: to nearest, ties to even (as Python's round)
        qx = round(px / _XY_ONE) << _XY_SHIFT
        qy = round(py / _XY_ONE) << _XY_SHIFT
        qx += round(px - qx)
        qy += round(py - qy)
        if not out or out[-1] != (qx, qy):
            out.append((qx, qy))
    if len(out) == 1:
        out = [tuple(center), tuple(center)]
    return out


def _clip_line(w: int, h: int, p1, p2):
    """drawing.cpp's ``clipLine`` on a (w, h) box in fixed point."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y, ys=True):
        c = (x < 0) + (x > right) * 2
        return c + ((y < 0) * 4 + (y > bottom) * 8 if ys else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """drawing.cpp's ``Line2``, which ``FillConvexPoly`` draws its edges
    with: a fixed-point DDA along the major axis between the clipped ends,
    the far end put first."""
    h, w = img.shape[:2]
    ok, (x1, y1), (x2, y2) = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT,
                                        p1, p2)
    if not ok:
        return
    half = _XY_ONE >> 1
    steep = abs(y2 - y1) >= abs(x2 - x1)
    if steep:  # walk y: swap the axes, and back at the end
        x1, y1, x2, y2 = y1, x1, y2, x2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    step = _c_div((y2 - y1) << _XY_SHIFT, (x2 - x1) | 1)
    n = np.arange(((x2 - x1) >> _XY_SHIFT) + 1, dtype=np.int64)
    xs = np.concatenate([[(x2 + half) >> _XY_SHIFT],
                         ((x1 + half) >> _XY_SHIFT) + n])
    ys = np.concatenate([[(y2 + half) >> _XY_SHIFT],
                         (y1 + half + n * step) >> _XY_SHIFT])
    if steep:
        xs, ys = ys, xs
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _c_div(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex_poly(img: np.ndarray, v, color) -> None:
    """drawing.cpp's ``FillConvexPoly`` at shift XY_SHIFT, 8-connected: the
    outline by ``Line2``, then the scan lines between the two edges."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = _XY_ONE >> 1
    xs_all = [p[0] for p in v]
    ys_all = [p[1] for p in v]
    ymin = min(ys_all)
    imin = ys_all.index(ymin)
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    xmin = (min(xs_all) + delta) >> _XY_SHIFT
    xmax = (max(xs_all) + delta) >> _XY_SHIFT
    ymin = (ymin + delta) >> _XY_SHIFT
    ymax = (max(ys_all) + delta) >> _XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_ye = [ymin, ymin]
    e_x, e_dx = [-_XY_ONE, -_XY_ONE], [0, 0]
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0, di = e_idx[i], e_di[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e_ye[i] = ty
                        e_dx[i] = _c_div((xe - xs) * 2 + (ty - y),
                                         2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            x1 = (e_x[left] + delta) >> _XY_SHIFT
            x2 = (e_x[right] + delta) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def fill_ellipse(img: np.ndarray, center: Tuple[int, int],
                 axes: Tuple[int, int], angle: int, color) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, angle, 0, 360, color,
    thickness=-1)`` on a (H, W) image, in place; ``center`` is (x, y)."""
    cx = int(center[0]) << _XY_SHIFT
    cy = int(center[1]) << _XY_SHIFT
    ax = abs(int(axes[0])) << _XY_SHIFT
    ay = abs(int(axes[1])) << _XY_SHIFT
    size = (max(ax, ay) + (_XY_ONE >> 1)) >> _XY_SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    poly = _ellipse_poly((cx, cy), (ax, ay), int(angle), delta)
    _fill_convex_poly(img, poly, color)
    return img
