"""Visualization dumps (the port's copy of
``implicit_depth_tpu/train/visualize.py``; PNGs through ``data/png.py``,
so that no OpenCV is needed).

Parity: TrainLIDF.visualize (src/trainers/train_lidf.py:486-581): a 3-panel
PNG (rgb / corrupt mask / valid mask), four PLY point clouds (input, GT,
prediction, prediction-in-transparent-region), and surface-normal images.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict

import numpy as np
import torch

from implicit_depth_torch.data.augmentation import unstandardize_image
from implicit_depth_torch.utils.ply import save_point_cloud
from implicit_depth_torch.data.png import write_png


def _normal_png(normal_img: np.ndarray) -> np.ndarray:
    return ((normal_img + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def dump_batch_visuals(out_dir: str, prefix: str, batch: Dict[str, np.ndarray],
                       inputs, pred_pos, index: int = 0) -> None:
    """Write PNG panels + PLY clouds for one image of a batch (host arrays
    or tensors)."""
    batch = {k: _host(batch[k][index]) for k in
             ("rgb", "corrupt_mask", "valid_mask", "xyz", "xyz_corrupt")}
    rgb = unstandardize_image(batch["rgb"])
    corrupt = (batch["corrupt_mask"] * 255).astype(np.uint8)
    valid = (batch["valid_mask"] * 255).astype(np.uint8)
    h, w = corrupt.shape
    panel = np.concatenate([rgb, *(np.repeat(m[..., None], 3, -1)
                                   for m in (corrupt, valid))], axis=1)
    write_png(osp.join(out_dir, f"{prefix}_panel.png"), panel)

    rgb01 = rgb.astype(np.float32) / 255.0
    xyz = batch["xyz"].reshape(-1, 3)
    xyz_corrupt = batch["xyz_corrupt"].reshape(-1, 3)
    colors = rgb01.reshape(-1, 3)

    inp_sel = xyz_corrupt[:, 2] > 0
    save_point_cloud(osp.join(out_dir, f"{prefix}_inp.ply"),
                     xyz_corrupt[inp_sel], colors[inp_sel])
    gt_sel = xyz[:, 2] > 0
    save_point_cloud(osp.join(out_dir, f"{prefix}_gt.ply"),
                     xyz[gt_sel], colors[gt_sel])

    midx = _host(inputs["miss_idx"][index])
    slot = _host(inputs["miss_slot"][index])
    pred = _host(pred_pos[index]).astype(np.float32)
    pred_cloud = xyz_corrupt.copy()
    pred_cloud[midx[slot]] = pred[slot]
    sel = pred_cloud[:, 2] > 0
    save_point_cloud(osp.join(out_dir, f"{prefix}_pred.ply"),
                     pred_cloud[sel], colors[sel])

    mask_flat = batch["corrupt_mask"].reshape(-1) > 0.5
    trans_sel = np.zeros(h * w, bool)
    trans_sel[midx[slot]] = True
    trans_sel &= mask_flat
    save_point_cloud(osp.join(out_dir, f"{prefix}_pred_transparent.ply"),
                     pred_cloud[trans_sel], colors[trans_sel])

    # surface-normal images of GT and predicted clouds (train_lidf.py:486-581)
    for name, cloud in (("gt", xyz), ("pred", pred_cloud)):
        img = cloud.reshape(h, w, 3)
        dx = np.zeros_like(img)
        dy = np.zeros_like(img)
        dx[:, :-1] = img[:, 1:] - img[:, :-1]
        dy[:-1, :] = img[1:, :] - img[:-1, :]
        n = np.cross(dx, dy)
        n /= np.sqrt((n * n).sum(-1, keepdims=True) + 1e-12)
        write_png(osp.join(out_dir, f"{prefix}_{name}_normal.png"),
                  _normal_png(n))
