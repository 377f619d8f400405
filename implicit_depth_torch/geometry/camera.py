"""Pinhole camera back-projection (counterpart of
``implicit_depth_tpu/geometry/camera.py::compute_xyz``): x = (u - cx) * z / fx,
y = (v - cy) * z / fy in camera space."""

from __future__ import annotations

import torch


def compute_xyz(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """depth (..., H, W); fx/fy/cx/cy scalars or (...,) tensors ->
    (..., H, W, 3)."""
    h, w = depth.shape[-2:]
    kw = {"dtype": depth.dtype, "device": depth.device}
    v = torch.arange(h, **kw)[:, None]
    u = torch.arange(w, **kw)[None, :]
    fx, fy, cx, cy = (torch.as_tensor(a, **kw)[..., None, None]
                      for a in (fx, fy, cx, cy))
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)
