"""Dense static-shape voxelization of the camera frustum box (counterpart of
``implicit_depth_tpu/geometry/voxel.py``).

The FULL dense grid of G³ cells per image is kept (G = res + 1 after the
half-voxel margin; 9³ = 729 for res 8) with a boolean occupancy mask. Linear
cell id = (ix*Gy + iy)*Gz + iz.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from implicit_depth_torch import constants


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Static grid geometry."""

    xmin0: Tuple[float, float, float]  # grid origin (after half-voxel margin)
    part_size: float                   # voxel edge length
    dims: Tuple[int, int, int]         # cells per axis (Gx, Gy, Gz)

    @property
    def n_cells(self) -> int:
        gx, gy, gz = self.dims
        return gx * gy * gz

    def cell_of(self, pts: torch.Tensor) -> torch.Tensor:
        """(..., 3) points -> (..., 3) int32 cell coords (may be out of bounds)."""
        xmin0 = torch.tensor(self.xmin0, dtype=pts.dtype, device=pts.device)
        return torch.floor((pts - xmin0) / self.part_size).to(torch.int32)

    def in_bounds(self, ijk: torch.Tensor) -> torch.Tensor:
        """(..., 3) cell coords -> (...,) bool inside the grid."""
        dims = torch.tensor(self.dims, dtype=torch.int32, device=ijk.device)
        return ((ijk >= 0) & (ijk < dims)).all(dim=-1)

    def linear_id(self, ijk: torch.Tensor) -> torch.Tensor:
        """(..., 3) cell coords -> (...,) linear id. Caller masks out-of-bounds."""
        _, gy, gz = self.dims
        return (ijk[..., 0] * gy + ijk[..., 1]) * gz + ijk[..., 2]

    def unlinear(self, lin: torch.Tensor) -> torch.Tensor:
        """(...,) linear id -> (..., 3) cell coords."""
        _, gy, gz = self.dims
        iz = lin % gz
        iy = torch.div(lin, gz, rounding_mode="floor") % gy
        ix = torch.div(lin, gy * gz, rounding_mode="floor")
        return torch.stack([ix, iy, iz], dim=-1)

    def cell_center(self, ijk: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """(..., 3) cell coords -> (..., 3) cell center position."""
        xmin0 = torch.tensor(self.xmin0, dtype=dtype, device=ijk.device)
        return xmin0 + ijk.to(dtype) * self.part_size + 0.5 * self.part_size


def make_voxel_grid(res: int = 8, xmin=constants.XMIN,
                    xmax=constants.XMAX) -> VoxelGrid:
    """Build the grid the way the reference does (pipeline.py:167-173)."""
    xmin = np.asarray(xmin, np.float64)
    xmax = np.asarray(xmax, np.float64)
    part = float(np.min(xmax - xmin)) / res
    xmin0 = xmin - 0.5 * part
    xmax0 = xmax + 0.5 * part
    dims = tuple(int(d) for d in np.ceil((xmax0 - xmin0) / part - 1e-9))
    return VoxelGrid(xmin0=tuple(float(v) for v in xmin0), part_size=part,
                     dims=dims)


def voxelize_points(grid: VoxelGrid, pts: torch.Tensor,
                    point_mask: torch.Tensor):
    """Assign (B, N, 3) points to dense grid cells; ``point_mask`` (B, N)
    False entries are ignored. Returns cell_id (B, N) int32 (0 for invalid
    points), valid (B, N), rel_coord (B, N, 3) = point minus its voxel
    center, occupancy (B, G³) bool."""
    ijk = grid.cell_of(pts)
    valid = point_mask & grid.in_bounds(ijk)
    lin = torch.where(valid, grid.linear_id(ijk), torch.zeros_like(ijk[..., 0]))
    rel = pts - grid.cell_center(ijk, pts.dtype)
    occ = torch.zeros((pts.shape[0], grid.n_cells), dtype=torch.int32,
                      device=pts.device)
    occ.scatter_reduce_(1, lin.long(), valid.to(torch.int32), "amax")
    return {"cell_id": lin, "valid": valid, "rel_coord": rel,
            "occupancy": occ > 0}
