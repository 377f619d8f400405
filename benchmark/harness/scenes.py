"""The traffic generator: seeded synthetic RGB-D scenes (a tilted
background plane and a few spheres, the first of them transparent, their
depth missing), as training batches and as camera frames. A frozen copy
of the model's synthetic data, driven by a traffic file's parameters:

- ``batch``, ``height``, ``width``: the shapes of one batch or call;
- ``pool``: how many distinct batches (or calls' worth of frames) set-up
  makes and the window cycles;
- ``objects`` [lo, hi): spheres a scene, the first ``transparent`` of them
  transparent (default 1); ``radius`` [lo, hi): a sphere's
  radius as a share of the width; ``depth`` [lo, hi): the plane's depth in
  metres; ``tilt``: the plane's largest slope;
- ``intrinsics_jitter``: each frame's own focal lengths and principal
  point, scaled by 1 + U(-j, j) (0: the sensor's).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IMG_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMG_NORM = np.asarray((0.229, 0.224, 0.225), np.float32)
FOV = (1.2112585306167603, 0.7428327202796936)


def standardize(rgb_u8: np.ndarray) -> np.ndarray:
    return (rgb_u8.astype(np.float32) / 255.0 - IMG_MEAN) / IMG_NORM


def xyz(depth: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    h, w = depth.shape
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((h, w, 3), np.float32)
    np.multiply(u - cx, depth, out=out[..., 0])
    out[..., 0] /= fx
    np.multiply(v - cy, depth, out=out[..., 1])
    out[..., 1] /= fy
    out[..., 2] = depth
    return out


def _intrinsics(rng, h, w, jitter):
    fx = w * 0.5 / np.tan(FOV[0] * 0.5)
    fy = h * 0.5 / np.tan(FOV[1] * 0.5)
    k = np.array([fx, fy, w * 0.5, h * 0.5])
    if jitter:
        k = k * (1.0 + rng.uniform(-jitter, jitter, 4))
    return tuple(np.float32(v) for v in k)


def _scene(rng, h, w, t, k):
    """(depth, transparent mask, rgb_u8) of one scene."""
    fx, _, cx, cy = k
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z0 = rng.uniform(*t.get("depth", (0.8, 1.6)))
    a, b = rng.uniform(-t.get("tilt", 0.2), t.get("tilt", 0.2), size=2)
    depth = z0 + a * (u - cx) / w + b * (v - cy) / h
    base = rng.uniform(0.25, 0.9, size=3).astype(np.float32)
    check = (((u // 32).astype(np.int32) + (v // 32).astype(np.int32)) % 2
             ).astype(np.float32) * 0.18
    albedo = np.clip(base * (0.82 + check[..., None]), 0, 1)
    shade = np.ones((h, w), np.float32)
    clear = np.zeros((h, w), bool)
    for i in range(int(rng.integers(*t.get("objects", (2, 5))))):
        ou, ov = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        rad = rng.uniform(*t.get("radius", (0.05, 0.15))) * w
        d2 = (u - ou) ** 2 + (v - ov) ** 2
        inside = d2 < rad ** 2
        bump = np.sqrt(np.maximum(rad ** 2 - d2, 0.0)) / fx
        depth = np.where(inside, depth - rng.uniform(0.05, 0.3) - bump, depth)
        col = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
        shade = np.where(inside, 0.55 + 0.45 * bump / (bump.max() + 1e-9),
                         shade)
        clear &= ~inside
        if i < t.get("transparent", 1):
            clear |= inside
            albedo = np.where(inside[..., None], albedo * 0.8 + 0.2 * col,
                              albedo)
        else:
            albedo = np.where(inside[..., None], col, albedo)
    light = 0.6 + 0.4 * np.clip((u / w + (1 - v / h)) / 2, 0, 1)
    rgb = np.clip(albedo * (shade * light)[..., None] * 255.0, 0, 255)
    return depth.astype(np.float32), clear, rgb.astype(np.uint8)


def frames(rng: np.random.Generator, t: Dict) -> List[Dict]:
    """One call's frames: rgb_u8 (H, W, 3), depth (H, W) with 0 over the
    transparent object, intrinsics (fx, fy, cx, cy)."""
    h, w = t["height"], t["width"]
    out = []
    for _ in range(t["batch"]):
        k = _intrinsics(rng, h, w, t.get("intrinsics_jitter", 0.0))
        depth, clear, rgb = _scene(rng, h, w, t, k)
        out.append({"rgb_u8": rgb, "depth": np.where(clear, 0.0, depth
                                                     ).astype(np.float32),
                    "intrinsics": k})
    return out


def train_batch(rng: np.random.Generator, t: Dict) -> Dict[str, np.ndarray]:
    """A training batch in the loaders' contract: rgb standardised, xyz and
    xyz_corrupt (B, H, W, 3), depth_corrupt, corrupt_mask, valid_mask
    (B, H, W), fx, fy, cx, cy (B,); the corrupted pixels are the
    transparent object's."""
    h, w = t["height"], t["width"]
    rows = []
    for _ in range(t["batch"]):
        k = _intrinsics(rng, h, w, t.get("intrinsics_jitter", 0.0))
        depth, clear, rgb = _scene(rng, h, w, t, k)
        corrupt = clear.astype(np.float32)
        dc = depth * (1.0 - corrupt)
        rows.append({"rgb": standardize(rgb), "depth": depth,
                     "depth_corrupt": dc, "xyz": xyz(depth, *k),
                     "xyz_corrupt": xyz(dc, *k),
                     "corrupt_mask": corrupt, "valid_mask": 1.0 - corrupt,
                     "fx": k[0], "fy": k[1], "cx": k[2], "cy": k[3]})
    return {key: np.stack([r[key] for r in rows]) for key in rows[0]}
