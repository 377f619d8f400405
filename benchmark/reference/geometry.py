"""The plain reference's geometry: camera rays, the valid-point and miss-ray
draws, the dense voxel grid, the ray/grid pair slots and the surface
normals of the loss.

A frozen copy of the mathematics that the model under test is specified
by (the reference implicit_depth pipeline as its ports compute it): the
same float32 operations in the same order, and the same draws from a
``torch.Generator`` in the same order, so that the same seed gives the
same points, rays and pair slots. It imports nothing but torch and numpy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

XMIN = (-1.0, -1.0, 0.0)
XMAX = (1.0, 1.0, 2.0)


@dataclasses.dataclass(frozen=True)
class Grid:
    """The frustum box cut into cubic cells: origin, edge, cells per axis;
    a cell's linear id is (ix·Gy + iy)·Gz + iz."""

    xmin0: Tuple[float, float, float]
    part: float
    dims: Tuple[int, int, int]

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    def cell_of(self, pts):
        x0 = torch.tensor(self.xmin0, dtype=pts.dtype, device=pts.device)
        return torch.floor((pts - x0) / self.part).to(torch.int32)

    def in_bounds(self, ijk):
        d = torch.tensor(self.dims, dtype=torch.int32, device=ijk.device)
        return ((ijk >= 0) & (ijk < d)).all(-1)

    def linear_id(self, ijk):
        _, gy, gz = self.dims
        return (ijk[..., 0] * gy + ijk[..., 1]) * gz + ijk[..., 2]

    def unlinear(self, lin):
        _, gy, gz = self.dims
        return torch.stack([torch.div(lin, gy * gz, rounding_mode="floor"),
                            torch.div(lin, gz, rounding_mode="floor") % gy,
                            lin % gz], -1)

    def center(self, ijk, dtype=torch.float32):
        x0 = torch.tensor(self.xmin0, dtype=dtype, device=ijk.device)
        return x0 + ijk.to(dtype) * self.part + 0.5 * self.part


def make_grid(res: int) -> Grid:
    xmin, xmax = np.asarray(XMIN, np.float64), np.asarray(XMAX, np.float64)
    part = float(np.min(xmax - xmin)) / res
    lo, hi = xmin - 0.5 * part, xmax + 0.5 * part
    dims = tuple(int(d) for d in np.ceil((hi - lo) / part - 1e-9))
    return Grid(tuple(float(v) for v in lo), part, dims)


def compute_xyz(depth, fx, fy, cx, cy):
    """depth (B, H, W), intrinsics (B,) -> (B, H, W, 3) camera points."""
    h, w = depth.shape[-2:]
    kw = {"dtype": depth.dtype, "device": depth.device}
    v = torch.arange(h, **kw)[:, None]
    u = torch.arange(w, **kw)[None, :]
    fx, fy, cx, cy = (torch.as_tensor(a, **kw)[..., None, None]
                      for a in (fx, fy, cx, cy))
    return torch.stack([(u - cx) * depth / fx, (v - cy) * depth / fy, depth],
                       -1)


def ray_dirs(h, w, fx, fy, cx, cy, device):
    """(B, H, W, 3) unit rays through each pixel: (x - cx, (y - cy)·fx/fy,
    fx), normalised."""
    kw = {"dtype": torch.float32, "device": device}
    yy, xx = torch.meshgrid(torch.arange(h, **kw), torch.arange(w, **kw),
                            indexing="ij")
    fx, fy, cx, cy = (torch.as_tensor(a, **kw)[..., None, None]
                      for a in (fx, fy, cx, cy))
    cam_x, cam_y, cam_z = torch.broadcast_tensors(xx - cx,
                                                  (yy - cy) * fx / fy, fx)
    d = torch.stack([cam_x, cam_y, cam_z], -1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def uniform(shape, gen, device):
    """U[0, 1) of ``shape`` drawn from ``gen`` on its own device."""
    dev = gen.device if gen is not None else device
    return torch.rand(shape, generator=gen, device=dev).to(device)


@functools.lru_cache(maxsize=8)
def _block_perm(h, w, by=8, bx=8):
    ids = np.arange(h * w).reshape(h // by, by, w // bx, bx)
    return ids.transpose(0, 2, 1, 3).reshape(-1)


def _true_order(mask, rank=None):
    """(B, M) bool -> (B, M): the index of each row's j-th True entry."""
    b, m = mask.shape
    if rank is None:
        rank = torch.cumsum(mask.long(), 1) - 1
    rank = torch.where(mask, rank.long(), torch.full_like(rank, m,
                                                          dtype=torch.long))
    order = torch.zeros((b, m + 1), dtype=torch.long, device=mask.device)
    order.scatter_(1, rank, torch.arange(m, device=mask.device).expand(b, m))
    return order[:, :m]


def sample_valid(valid_mask, n, gen):
    """Exactly ``n`` valid pixels an image, stratified over the valid set in
    8×8 block-scan order, repeated where fewer exist -> (idx, slot)."""
    b, h, w = valid_mask.shape
    dev = valid_mask.device
    perm = torch.from_numpy(_block_perm(h, w)).to(dev)
    mb = valid_mask.reshape(b, h * w)[:, perm]
    order = _true_order(mb)
    cnt = mb.sum(1)
    cs = cnt.clamp(min=1)
    i = torch.arange(n, device=dev)
    stride = (cs // n).clamp(min=1)
    u = uniform((b, n), gen, dev)
    jit = torch.minimum((u * stride[:, None]).long(), stride[:, None] - 1)
    many = torch.minimum((i * cs[:, None]) // n + jit, cs[:, None] - 1)
    few = i % cs[:, None]
    r = torch.where((cnt >= n)[:, None], many, few)
    return (perm[order.gather(1, r)].to(torch.int32),
            (cnt > 0)[:, None].expand(b, n))


def sample_window(mask_flat, n, gen, rank):
    """A random window of ``n`` consecutive mask pixels an image (raster
    order) -> (idx, slot, start)."""
    b, m = mask_flat.shape
    dev = mask_flat.device
    order = _true_order(mask_flat, rank)
    cnt = mask_flat.sum(1)
    top = (cnt - n).clamp(min=0)
    u = uniform((b,), gen, dev)
    start = torch.minimum((u * (top + 1)).long(), top)
    j = start[:, None] + torch.arange(n, device=dev)
    return order.gather(1, j).to(torch.int32), j < cnt[:, None], start


def voxelize(grid: Grid, pts, mask):
    ijk = grid.cell_of(pts)
    valid = mask & grid.in_bounds(ijk)
    lin = torch.where(valid, grid.linear_id(ijk), torch.zeros_like(ijk[..., 0]))
    rel = pts - grid.center(ijk, pts.dtype)
    occ = torch.zeros((pts.shape[0], grid.n_cells), dtype=torch.int32,
                      device=pts.device)
    occ.scatter_reduce_(1, lin.long(), valid.to(torch.int32), "amax")
    return lin, valid, rel, occ > 0


def ray_pairs(grid: Grid, d, occ, k, ray_mask):
    """The first ``k`` occupied cells that each ray's line crosses, in t
    order -> (cell, valid, t_enter, t_exit), each (B, R, k)."""
    b, r, _ = d.shape
    f32 = {"dtype": torch.float32, "device": d.device}
    x0 = torch.tensor(grid.xmin0, **f32)
    part = torch.tensor(grid.part, **f32)
    inv = 1.0 / (d + 1e-12)
    ext = torch.tensor(grid.dims, **f32) * part
    lo, hi = x0 * inv, (x0 + ext) * inv
    t0 = torch.minimum(lo, hi).amax(-1)
    t1 = torch.maximum(lo, hi).amin(-1)
    ts = torch.cat([(x0[a] + part * torch.arange(grid.dims[a] + 1, **f32))
                    * inv[..., a:a + 1] for a in range(3)], -1)
    ts = torch.minimum(torch.maximum(ts, t0[..., None]), t1[..., None])
    ts = torch.sort(ts, -1).values
    ta, tb = ts[..., :-1], ts[..., 1:]
    ijk = grid.cell_of(d[..., None, :] * (0.5 * (ta + tb))[..., None])
    inb = grid.in_bounds(ijk)
    lin = torch.where(inb, grid.linear_id(ijk), torch.zeros_like(ijk[..., 0]))
    occ_seg = occ.gather(1, lin.reshape(b, -1).long()).reshape(lin.shape)
    good = (tb > ta) & inb & occ_seg & (t1 > t0)[..., None] & ray_mask[..., None]
    rank = torch.cumsum(good.long(), -1) - 1
    dest = torch.where(good & (rank < k), rank, torch.full_like(rank, k))

    def place(src, fill):
        out = torch.full((b, r, k + 1), fill, dtype=src.dtype, device=d.device)
        return out.scatter_(-1, dest, src)[..., :k]

    valid = place(good, False)
    zero = torch.zeros((), **f32)
    return (torch.where(valid, place(lin, 0), torch.zeros_like(lin[..., :1])),
            valid, torch.where(valid, place(ta, 0.0), zero),
            torch.where(valid, place(tb, 0.0), zero))


def normals_planar(pcl, eps=1e-8):
    """(B, 3, H, W) points -> (unit normals of dx × dy, dx, dy)."""
    dx = torch.cat([pcl[..., 1:] - pcl[..., :-1],
                    torch.zeros_like(pcl[..., :1])], 3)
    dy = torch.cat([pcl[:, :, 1:] - pcl[:, :, :-1],
                    torch.zeros_like(pcl[:, :, :1])], 2)
    n = torch.stack([dx[:, 1] * dy[:, 2] - dx[:, 2] * dy[:, 1],
                     dx[:, 2] * dy[:, 0] - dx[:, 0] * dy[:, 2],
                     dx[:, 0] * dy[:, 1] - dx[:, 1] * dy[:, 0]], 1)
    return n / torch.sqrt((n * n).sum(1, keepdim=True) + eps * eps), dx, dy


def prepare(grid: Grid, batch, *, train, n_valid, n_rays, k_pairs, gen):
    """The geometry of a batch: points, voxels, rays, pair slots, labels.
    ``batch`` holds rgb (B,H,W,3) standardised, xyz and xyz_corrupt
    (B,H,W,3), depth_corrupt, corrupt_mask, valid_mask (B,H,W) and fx, fy,
    cx, cy (B,). Serving: every pixel a ray, every non-zero depth a valid
    pixel. Training: a window of ``n_rays`` corrupted pixels. Draws from
    ``gen``: the valid points, then (training) the window's start."""
    rgb = batch["rgb"]
    b, h, w, _ = rgb.shape
    dev = rgb.device
    if train:
        miss_mask = batch["corrupt_mask"] > 0.5
        valid_mask = batch["valid_mask"] > 0.5
    else:
        miss_mask = torch.ones((b, h, w), dtype=torch.bool, device=dev)
        valid_mask = batch["depth_corrupt"] != 0
    vidx, vslot = sample_valid(valid_mask, n_valid, gen)
    xyzc = batch["xyz_corrupt"].reshape(b, h * w, 3)
    vg = torch.cat([xyzc, rgb.reshape(b, h * w, 3)], -1).gather(
        1, vidx.long()[..., None].expand(-1, -1, 6))
    vxyz, vrgb = vg[..., :3], vg[..., 3:]
    vcell, vok, vrel, occ = voxelize(grid, vxyz, vslot)
    dirs = ray_dirs(h, w, batch["fx"], batch["fy"], batch["cx"], batch["cy"],
                    dev).reshape(b, h * w, 3)
    xyz = batch["xyz"].reshape(b, h * w, 3)
    out = {}
    if train:
        mflat = miss_mask.reshape(b, -1)
        mrank = torch.cumsum(mflat.int(), 1, dtype=torch.int32) - 1
        midx, mslot, mstart = sample_window(mflat, n_rays, gen, mrank)
        mg = torch.cat([dirs, xyz, rgb.reshape(b, h * w, 3)], -1).gather(
            1, midx.long()[..., None].expand(-1, -1, 9))
        mdir, gt, mrgb = mg[..., :3], mg[..., 3:6], mg[..., 6:]
        out.update(miss_rank=mrank, miss_start=mstart)
    else:
        midx = torch.arange(h * w, dtype=torch.int32, device=dev).expand(b, -1)
        mslot = miss_mask.reshape(b, -1)
        mflat = mslot
        mdir, gt, mrgb = dirs, xyz, rgb.reshape(b, h * w, 3)
    cell, pvalid, t_in, t_out = ray_pairs(grid, mdir, occ, k_pairs, mslot)
    gijk = grid.cell_of(gt)
    gcell = torch.where(grid.in_bounds(gijk), grid.linear_id(gijk),
                        torch.full_like(gijk[..., 0], -1))
    out.update(
        rgb=rgb, xyz_flat=xyz, xyz_corrupt_flat=xyzc, valid_xyz=vxyz,
        valid_rgb=vrgb, vox_cell=vcell, vox_ok=vok, vox_rel=vrel,
        occupancy=occ, miss_idx=midx, miss_slot=mslot, miss_mask_flat=mflat,
        miss_dir=mdir, miss_rgb=mrgb, miss_px=midx % w,
        miss_py=torch.div(midx, w, rounding_mode="floor"), pair_cell=cell,
        pair_valid=pvalid, t_enter=t_in, t_exit=t_out, gt_pos=gt,
        pair_label=pvalid & (cell == gcell[..., None]))
    return out
