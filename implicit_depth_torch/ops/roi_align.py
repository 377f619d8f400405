"""ROI feature pooling for pixel-centred boxes (counterpart of
``implicit_depth_tpu/ops/roi_align.py::roi_window_pool``).

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
