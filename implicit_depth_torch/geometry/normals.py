"""Image-space gradients and surface normals of an ordered point cloud
(counterpart of ``implicit_depth_tpu/geometry/normals.py``): dx = right -
left with a zero last column, dy = bottom - top with a zero last row;
normal = normalize(dx × dy) with the norm sqrt(|n|² + eps²), whose gradient
stays finite where the cross product is 0 (the image border)."""

from __future__ import annotations

import torch


def image_gradients(x: torch.Tensor):
    """x (B, H, W, C) -> (dx, dy) of the same shape."""
    dx = torch.cat([x[:, :, 1:] - x[:, :, :-1], torch.zeros_like(x[:, :, :1])], 2)
    dy = torch.cat([x[:, 1:] - x[:, :-1], torch.zeros_like(x[:, :1])], 1)
    return dx, dy


def image_gradients_planar(x: torch.Tensor):
    """x (B, 3, H, W) channel-planar -> (dx, dy) of the same shape."""
    dx = torch.cat([x[..., 1:] - x[..., :-1], torch.zeros_like(x[..., :1])], 3)
    dy = torch.cat([x[:, :, 1:] - x[:, :, :-1], torch.zeros_like(x[:, :, :1])], 2)
    return dx, dy


def surface_normals_planar(pcl: torch.Tensor, eps: float = 1e-8):
    """pcl (B, 3, H, W) -> (normal (B, 3, H, W), dx, dy)."""
    dx, dy = image_gradients_planar(pcl)
    n = torch.stack([
        dx[:, 1] * dy[:, 2] - dx[:, 2] * dy[:, 1],
        dx[:, 2] * dy[:, 0] - dx[:, 0] * dy[:, 2],
        dx[:, 0] * dy[:, 1] - dx[:, 1] * dy[:, 0],
    ], 1)
    norm = torch.sqrt((n * n).sum(1, keepdim=True) + eps * eps)
    return n / norm, dx, dy


def surface_normals(pcl: torch.Tensor, eps: float = 1e-8):
    """pcl (B, H, W, 3) -> (normal (B, H, W, 3), dx, dy)."""
    dx, dy = image_gradients(pcl)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.sqrt((n * n).sum(-1, keepdim=True) + eps * eps)
    return n / norm, dx, dy
