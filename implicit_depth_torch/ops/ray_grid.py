"""Ray / voxel-grid intersection (counterpart of
``implicit_depth_tpu/ops/ray_grid.py::ray_grid_intersect``).

A ray's intersections with a regular grid are exactly the cells the LINE
crosses between consecutive plane crossings: sort the ray's parametric
crossings with all axis planes, test each segment's midpoint cell, then
rank and compact the hits into K t-sorted, front-packed slots (nearest K
kept on overflow). Same semantics as the reference's CUDA slab-test kernel:
the infinite line (no t >= 0 clamp) and the 1/(d + 1e-12) guard. Where the
JAX version contracts one-hot matrices on the TPU's matrix unit, this one
gathers the occupancy and scatters the hits into their slots directly.
"""

from __future__ import annotations

from typing import Dict

import torch

from implicit_depth_torch.geometry.voxel import VoxelGrid
from implicit_depth_torch.utils import profiling


def ray_grid_intersect(grid: VoxelGrid, ray_dir: torch.Tensor,
                       occupancy: torch.Tensor, k_pairs: int,
                       ray_mask: torch.Tensor | None = None
                       ) -> Dict[str, torch.Tensor]:
    """ray_dir (B, R, 3) normalized; occupancy (B, G³) bool; ray_mask (B, R).
    Returns cell_id (B, R, K) int32 (0 where invalid), valid (B, R, K) bool,
    t_enter / t_exit (B, R, K) f32 (0 where invalid)."""
    b, r, _ = ray_dir.shape
    dev = ray_dir.device
    f32 = {"dtype": torch.float32, "device": dev}
    with profiling.span("sync.ray_grid_consts"):  # copies from pageable memory
        xmin0 = torch.tensor(grid.xmin0, **f32)
        part = torch.tensor(grid.part_size, **f32)
        ext = torch.tensor(grid.dims, **f32) * part

    inv = 1.0 / (ray_dir + 1e-12)
    t_lo = xmin0 * inv
    t_hi = (xmin0 + ext) * inv
    t0 = torch.minimum(t_lo, t_hi).amax(dim=-1)            # (B, R)
    t1 = torch.maximum(t_lo, t_hi).amin(dim=-1)
    hits_grid = t1 > t0

    ts = torch.cat([(xmin0[a] + part * torch.arange(grid.dims[a] + 1, **f32))
                    * inv[..., a:a + 1] for a in range(3)], dim=-1)
    ts = torch.minimum(torch.maximum(ts, t0[..., None]), t1[..., None])
    ts = torch.sort(ts, dim=-1).values                     # (B, R, P)

    t_s, t_e = ts[..., :-1], ts[..., 1:]                   # (B, R, P-1)
    seg_len_ok = t_e > t_s
    mid = 0.5 * (t_s + t_e)
    ijk = grid.cell_of(ray_dir[..., None, :] * mid[..., None])
    inb = grid.in_bounds(ijk)
    lin = torch.where(inb, grid.linear_id(ijk), torch.zeros_like(ijk[..., 0]))
    occ_seg = occupancy.gather(1, lin.reshape(b, -1).long()).reshape(lin.shape)

    good = seg_len_ok & inb & occ_seg & hits_grid[..., None]
    if ray_mask is not None:
        good = good & ray_mask[..., None]

    # slot of each hit = its rank among the ray's hits; misses and hits past
    # K go to a spill slot K that is dropped
    rank = torch.cumsum(good.long(), dim=-1) - 1
    dest = torch.where(good & (rank < k_pairs), rank,
                       torch.full_like(rank, k_pairs))

    def place(src, fill):
        out = torch.full((b, r, k_pairs + 1), fill, dtype=src.dtype, device=dev)
        return out.scatter_(-1, dest, src)[..., :k_pairs]

    valid = place(good, False)
    zero = torch.zeros((), **f32)
    return {
        "cell_id": torch.where(valid, place(lin, 0), torch.zeros_like(lin[..., :1])),
        "valid": valid,
        "t_enter": torch.where(valid, place(t_s, 0.0), zero),
        "t_exit": torch.where(valid, place(t_e, 0.0), zero),
    }
