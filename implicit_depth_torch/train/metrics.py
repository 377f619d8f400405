"""Evaluation metrics and meters (the port's copy of
``implicit_depth_tpu/train/metrics.py``).

Parity: the ClearGrasp protocol hard-coded in the reference
(src/models/pipeline.py:571-618): depth maps resized to 256×144 with
cv2 INTER_NEAREST, masked by (gt>0) ∧ transparent seg mask, then
RMSE / rmse_log / log10 / abs_rel / MAE / sq_rel / δ<1.05 / 1.10 / 1.25.

Note: the reference's ``safe_log10`` is actually ln (pipeline.py:607), so its
"log10" column is off by ln(10). We compute a true log10 — protocol, not bug
(SURVEY.md §5.5) — and additionally report ``log10_ln`` for direct comparison
against numbers produced by the reference code.

``AverageValueMeter`` parity: src/utils/training_utils.py:74-89.

The 256×144 resize is :func:`resize_nearest`, a numpy gather at the indices
cv2 INTER_NEAREST takes, so that the metrics need no OpenCV.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

EVAL_W, EVAL_H = 256, 144


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index of each of ``dst`` output pixels:
    floor(x / (dst / src)) in double precision, clamped to the last."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                      src - 1)


def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` of an
    (H, W[, C]) image, bit for bit."""
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(
        img.shape[1], w)]


class AverageValueMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0

    def add(self, value, n: int = 1):
        self.sum += float(value) * n
        self.n += n

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0


class MeterBank:
    def __init__(self):
        self._meters: Dict[str, AverageValueMeter] = {}

    def add(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self._meters.setdefault(k, AverageValueMeter()).add(v, n)

    def means(self) -> Dict[str, float]:
        return {k: m.mean for k, m in self._meters.items()}

    def reset(self):
        for m in self._meters.values():
            m.reset()


def cleargrasp_metrics(pred_depth: np.ndarray,
                       gt_depth: np.ndarray,
                       seg_mask: np.ndarray,
                       resize: bool = True) -> Optional[Dict[str, float]]:
    """Masked depth metrics on one image.

    Args:
      pred_depth, gt_depth: (H, W) float meters.
      seg_mask: (H, W) {0,1} transparent-object mask.

    Returns metric dict, or None when the mask is empty.
    """
    gt = gt_depth.astype(np.float32)
    pred = pred_depth.astype(np.float32)
    seg = seg_mask.astype(np.uint8)
    if resize:
        gt = resize_nearest(gt, EVAL_W, EVAL_H)
        pred = resize_nearest(pred, EVAL_W, EVAL_H)
        seg = resize_nearest(seg, EVAL_W, EVAL_H)
    gt = np.nan_to_num(gt, nan=0.0, posinf=0.0, neginf=0.0)
    mask = (gt > 0) & (seg > 0)
    if not mask.any():
        return None
    g, p = gt[mask], pred[mask]

    safe = lambda x: np.clip(x, 1e-6, 1e6)
    # p may contain exact zeros (untrained / degenerate predictions); g/p
    # then yields +inf, which fails every δ threshold. A strictly NEGATIVE p
    # would instead make both ratios negative and PASS the thresholds — the
    # reference's torch maximum(gt/pred, pred/gt) has the identical behavior
    # (src/models/pipeline.py:588-591) and our predictions
    # are points along camera rays inside the z∈[0,2] frustum grid, so
    # negative depth is not reachable from the decode path. Silence only the
    # expected divide so real numeric regressions elsewhere stay visible.
    with np.errstate(divide="ignore"):
        thresh = np.maximum(g / p, p / g)
    ln_g, ln_p = np.log(safe(g)), np.log(safe(p))
    return {
        "a1": float((thresh < 1.05).mean()),
        "a2": float((thresh < 1.10).mean()),
        "a3": float((thresh < 1.25).mean()),
        "rmse": float(np.sqrt(((g - p) ** 2).mean())),
        "rmse_log": float(np.sqrt(((ln_g - ln_p) ** 2).mean())),
        "log10": float(np.abs(np.log10(safe(g)) - np.log10(safe(p))).mean()),
        "log10_ln": float(np.abs(ln_g - ln_p).mean()),
        "abs_rel": float((np.abs(g - p) / g).mean()),
        "mae": float(np.abs(g - p).mean()),
        "sq_rel": float((((g - p) ** 2) / g).mean()),
    }


def depth_images_from_outputs(inputs, pred_pos: torch.Tensor, h: int,
                              w: int) -> np.ndarray:
    """(B, H, W) predicted depth images on the host: the corrupt input's z
    with the predicted points' z written at the slotted miss pixels
    (pipeline.py:593-597). Computed on the tensors' device, read back
    once."""
    z = inputs["xyz_corrupt_flat"][..., 2]
    b, hw = z.shape
    # unslotted entries write into a spare column past the image
    idx = torch.where(inputs["miss_slot"], inputs["miss_idx"].long(),
                      torch.full_like(inputs["miss_idx"], hw, dtype=torch.long))
    out = torch.cat([z, z.new_zeros(b, 1)], 1).scatter(
        1, idx, pred_pos[..., 2].to(z.dtype))
    return out[:, :hw].reshape(b, h, w).cpu().numpy()
