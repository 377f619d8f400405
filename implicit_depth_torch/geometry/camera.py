"""Pinhole camera back-projection (counterpart of
``implicit_depth_tpu/geometry/camera.py``): x = (u - cx) * z / fx,
y = (v - cy) * z / fy in camera space."""

from __future__ import annotations

import numpy as np
import torch


def compute_xyz_np(depth: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) ordered point cloud on the host, in the
    JAX package's order of float32 operations."""
    h, w = depth.shape
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = depth.astype(np.float32, copy=False)
    out = np.empty((h, w, 3), np.float32)
    np.multiply(u - cx, depth, out=out[..., 0])
    out[..., 0] /= fx
    np.multiply(v - cy, depth, out=out[..., 1])
    out[..., 1] /= fy
    out[..., 2] = depth
    return out


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
