"""Procedural synthetic RGB-D scenes (the port's copy of
``implicit_depth_tpu/data/synthetic.py``): a tilted background plane plus a
few spheres, one of them "transparent". ``synthetic_batch`` gives training
batches (standardized RGB, GT and corrupted point clouds, corrupt and valid
masks) with the loaders' contract; ``synthetic_scene_raw`` gives frames at
the sensor's resolution for ``chip_smoke.py``'s serving phases.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from implicit_depth_torch import constants


def _xyz_np(depth: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) camera-space points, as
    ``implicit_depth_tpu/geometry/camera.py::compute_xyz_np`` computes them."""
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


def synthetic_sample(rng: np.random.Generator, h: int = 240,
                     w: int = 320) -> Dict[str, np.ndarray]:
    """One training sample: depth is removed inside the first sphere."""
    fov_x = 1.2112585306167603
    fov_y = 0.7428327202796936
    fx = w * 0.5 / np.tan(fov_x * 0.5)
    fy = h * 0.5 / np.tan(fov_y * 0.5)
    cx, cy = w * 0.5, h * 0.5

    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z0 = rng.uniform(0.8, 1.6)
    a, b = rng.uniform(-0.2, 0.2, size=2)
    depth = z0 + a * (u - cx) / w + b * (v - cy) / h

    corrupt_mask = np.zeros((h, w), np.float32)
    n_obj = rng.integers(2, 5)
    for i in range(n_obj):
        ou, ov = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        rad = rng.uniform(0.05, 0.15) * w
        d2 = (u - ou) ** 2 + (v - ov) ** 2
        inside = d2 < rad ** 2
        bump = np.sqrt(np.maximum(rad ** 2 - d2, 0.0)) / fx
        obj_z = depth - rng.uniform(0.05, 0.3) - bump
        depth = np.where(inside, obj_z, depth)
        if i == 0:  # first object is "transparent"
            corrupt_mask = np.where(inside, 1.0, corrupt_mask).astype(np.float32)

    depth = depth.astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, size=(h, w, 3)).astype(np.float32)
    rgb = (rgb - np.asarray(constants.IMG_MEAN, np.float32)) / np.asarray(
        constants.IMG_NORM, np.float32)

    depth_corrupt = depth * (1.0 - corrupt_mask)
    return {
        "rgb": rgb,
        "depth": depth,
        "depth_corrupt": depth_corrupt,
        "xyz": _xyz_np(depth, fx, fy, cx, cy),
        "xyz_corrupt": _xyz_np(depth_corrupt, fx, fy, cx, cy),
        "corrupt_mask": corrupt_mask,
        "valid_mask": (1.0 - corrupt_mask).astype(np.float32),
        "fx": np.float32(fx),
        "fy": np.float32(fy),
        "cx": np.float32(cx),
        "cy": np.float32(cy),
    }


def synthetic_batch(seed: int, batch_size: int, h: int = 240,
                    w: int = 320) -> Dict[str, np.ndarray]:
    """``batch_size`` samples from ``default_rng(seed)``, stacked."""
    rng = np.random.default_rng(seed)
    samples = [synthetic_sample(rng, h, w) for _ in range(batch_size)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def synthetic_scene_raw(rng: np.random.Generator, h: int = 480,
                        w: int = 640) -> Dict[str, np.ndarray]:
    """A plane + spheres scene with shaded uint8 RGB and per-object masks.

    Returns: rgb_u8 (H, W, 3) RGB; depth (H, W) f32 meters;
    object_masks (n_obj, H, W) bool; object_transparent (n_obj,) bool
    (at least one transparent); fov_x/fov_y (rads), fx/fy/cx/cy.
    """
    fov_x = 1.2112585306167603
    fov_y = 0.7428327202796936
    fx = w * 0.5 / np.tan(fov_x * 0.5)
    fy = h * 0.5 / np.tan(fov_y * 0.5)
    cx, cy = w * 0.5, h * 0.5

    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z0 = rng.uniform(0.8, 1.6)
    a, b = rng.uniform(-0.2, 0.2, size=2)
    depth = z0 + a * (u - cx) / w + b * (v - cy) / h

    # checkerboard albedo so JPEG has real structure to encode
    base = rng.uniform(0.25, 0.9, size=3).astype(np.float32)
    check = (((u // 32).astype(np.int32) + (v // 32).astype(np.int32)) % 2
             ).astype(np.float32) * 0.18
    albedo = np.clip(base[None, None, :] * (0.82 + check[..., None]), 0, 1)

    n_obj = int(rng.integers(2, 5))
    masks = np.zeros((n_obj, h, w), bool)
    transparent = np.zeros((n_obj,), bool)
    shade = np.ones((h, w), np.float32)
    for i in range(n_obj):
        ou, ov = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        rad = rng.uniform(0.05, 0.15) * w
        d2 = (u - ou) ** 2 + (v - ov) ** 2
        inside = d2 < rad ** 2
        bump = np.sqrt(np.maximum(rad ** 2 - d2, 0.0)) / fx
        obj_z = depth - rng.uniform(0.05, 0.3) - bump
        depth = np.where(inside, obj_z, depth)
        # masks are VISIBLE regions and must be disjoint: the loaders
        # reconstruct per-pixel ids as sum(plane_k · id_k), which breaks on
        # overlap. Each new object is drawn in front (obj_z < depth), so it
        # occludes earlier objects wherever they overlap.
        masks[:i] &= ~inside
        masks[i] = inside
        transparent[i] = i == 0  # first object is transparent (≙ sem id 2)
        col = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
        # crude sphere shading: brighter at the bump apex
        sph = 0.55 + 0.45 * (bump / (bump.max() + 1e-9))
        shade = np.where(inside, sph, shade)
        if transparent[i]:
            # transparent: background albedo shows through, slightly tinted
            albedo = np.where(inside[..., None],
                              albedo * 0.8 + 0.2 * col[None, None, :], albedo)
        else:
            albedo = np.where(inside[..., None], col[None, None, :], albedo)

    light = 0.6 + 0.4 * np.clip((u / w + (1 - v / h)) / 2, 0, 1)
    rgb = np.clip(albedo * (shade * light)[..., None] * 255.0, 0, 255)
    return {
        "rgb_u8": rgb.astype(np.uint8),
        "depth": depth.astype(np.float32),
        "object_masks": masks,
        "object_transparent": transparent,
        "fov_x": np.float32(fov_x), "fov_y": np.float32(fov_y),
        "fx": np.float32(fx), "fy": np.float32(fy),
        "cx": np.float32(cx), "cy": np.float32(cy),
    }
