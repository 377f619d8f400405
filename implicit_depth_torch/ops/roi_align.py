"""ROI feature pooling (counterpart of
``implicit_depth_tpu/ops/roi_align.py``).

:func:`roi_align` is the general ROIAlign with torchvision's semantics
(the aligned half-pixel offset, an adaptive sampling grid per box capped at
``max_grid``, bilinear samples zero outside [-1, H] x [-1, W]): the exact
reference of the pooling, which no model calls.

:func:`roi_window_pool` is the models' pooling of pixel-centred boxes.
For an interior pixel the reference's 8×8 torchvision ROIAlign box
(aligned=True, 2×2 output) samples exactly integer pixels, so each output
bin is a 4×4 pixel-block mean: mean-pool the map once (4×4, stride 1) and
gather the four bin corners per ray. Border rays take a window shifted fully
inside the image (the JAX package's documented divergence). The four
corners are packed channel-wise in spatial-major (out, out, C) order, the
JAX layout, so decoder weights carry over with transposes only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bilinear(feat: torch.Tensor, bidx: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C) sampled at image ``bidx`` and (y, x), each of one
    shape (...,) -> (..., C): torchvision's border rule, 0 outside [-1, H] x
    [-1, W], the coordinates clamped into the image otherwise."""
    h, w = feat.shape[1], feat.shape[2]
    outside = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y, x = y.clamp(0.0, h - 1), x.clamp(0.0, w - 1)
    y0, x0 = y.floor().long(), x.floor().long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    b = bidx.long()

    def g(yy, xx):
        return feat[b, yy, xx]

    val = (g(y0, x0) * (hy * hx)[..., None]
           + g(y0, x1) * (hy * lx)[..., None]
           + g(y1, x0) * (ly * hx)[..., None]
           + g(y1, x1) * (ly * lx)[..., None])
    return torch.where(outside[..., None], torch.zeros((), dtype=val.dtype,
                                                       device=val.device), val)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              box_batch: torch.Tensor, output_size: int = 2,
              max_grid: int = 4, sampling_ratio: int = -1,
              aligned: bool = True) -> torch.Tensor:
    """General ROIAlign. feat (B, H, W, C); boxes (N, 4) as (x1, y1, x2, y2)
    in image coordinates; box_batch (N,) int image of each box -> (N,
    output_size, output_size, C). Each bin averages a grid of
    ``sampling_ratio``² samples, or (``sampling_ratio`` <= 0) of
    ceil(bin size) per side, clamped to [1, max_grid]."""
    o = output_size
    off = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (boxes[:, i] - off for i in range(4))
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    bin_w, bin_h = roi_w / o, roi_h / o
    if sampling_ratio > 0:
        gw = torch.full_like(roi_w, float(sampling_ratio))
        gh = torch.full_like(roi_h, float(sampling_ratio))
    else:
        gw = bin_w.ceil().clamp(1, max_grid)
        gh = bin_h.ceil().clamp(1, max_grid)
    dt, dev = feat.dtype, feat.device
    s = torch.arange(max_grid, dtype=dt, device=dev)
    a = torch.arange(o, dtype=dt, device=dev)
    # sample coordinates (N, o, S)
    ys = (y1[:, None, None] + a[None, :, None] * bin_h[:, None, None]
          + (s[None, None, :] + 0.5) * (bin_h / gh)[:, None, None])
    xs = (x1[:, None, None] + a[None, :, None] * bin_w[:, None, None]
          + (s[None, None, :] + 0.5) * (bin_w / gw)[:, None, None])
    ay = s[None, None, :] < gh[:, None, None]
    ax = s[None, None, :] < gw[:, None, None]
    n = boxes.shape[0]
    shape = (n, o, o, max_grid, max_grid)
    yy = ys[:, :, None, :, None].expand(shape)
    xx = xs[:, None, :, None, :].expand(shape)
    act = ay[:, :, None, :, None] & ax[:, None, :, None, :]
    vals = _bilinear(feat, box_batch[:, None, None, None, None].expand(shape),
                     yy, xx)
    vals = torch.where(act[..., None], vals, torch.zeros((), dtype=dt,
                                                         device=dev))
    count = (gh * gw).clamp(min=1.0)[:, None, None, None]
    return vals.sum((3, 4)) / count


def roi_window_pool(feat: torch.Tensor, pix_xy: torch.Tensor,
                    pix_batch: torch.Tensor, inp_bbox: int = 8,
                    out_bbox: int = 2) -> torch.Tensor:
    """feat (B, H, W, C); pix_xy (..., 2) int (x, y); pix_batch (...,) int
    -> (..., out_bbox, out_bbox, C)."""
    b, h, w, c = feat.shape
    half = inp_bbox // 2
    win = inp_bbox // out_bbox
    pooled = F.avg_pool2d(feat.permute(0, 3, 1, 2), win, stride=1)
    pooled = pooled.permute(0, 2, 3, 1)                    # (B, ph, pw, C)
    ph, pw = pooled.shape[1], pooled.shape[2]
    ph2, pw2 = ph - win * (out_bbox - 1), pw - win * (out_bbox - 1)
    corners = [pooled[:, dy:dy + ph2, dx:dx + pw2]
               for dy in range(0, out_bbox * win, win)
               for dx in range(0, out_bbox * win, win)]
    packed = torch.cat(corners, dim=-1)                    # (B, ph2, pw2, out²·C)

    px = pix_xy[..., 0].clamp(half, w - half)
    py = pix_xy[..., 1].clamp(half, h - half)
    gy = (py - half).clamp(0, ph2 - 1)
    gx = (px - half).clamp(0, pw2 - 1)
    flat = packed.reshape(b * ph2 * pw2, out_bbox * out_bbox * c)
    lin = (pix_batch.long() * ph2 + gy) * pw2 + gx
    return flat[lin.long()].reshape(*pix_xy.shape[:-1], out_bbox, out_bbox, c)
