"""Camera ray directions (counterpart of
``implicit_depth_tpu/geometry/rays.py::ray_dir_map``):
dir = normalize(x - cx, (y - cy) * fx / fy, fx); the camera sits at the
origin."""

from __future__ import annotations

import torch


def ray_dir_map(h: int, w: int, fx, fy, cx, cy,
                device: torch.device | str = "cpu",
                dtype=torch.float32) -> torch.Tensor:
    """Normalized per-pixel ray directions, (..., h, w, 3); fx/fy/cx/cy are
    scalars or batched (...,) tensors."""
    kw = {"dtype": dtype, "device": device}
    yy, xx = torch.meshgrid(torch.arange(h, **kw), torch.arange(w, **kw),
                            indexing="ij")
    fx, fy, cx, cy = (torch.as_tensor(a, **kw)[..., None, None]
                      for a in (fx, fy, cx, cy))
    cam_x = xx - cx
    cam_y = (yy - cy) * fx / fy
    cam_x, cam_y, cam_z = torch.broadcast_tensors(cam_x, cam_y, fx)
    d = torch.stack([cam_x, cam_y, cam_z], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
