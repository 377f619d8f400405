"""Host-side data augmentation (the port's copy of
``implicit_depth_tpu/data/augmentation.py``, on ``data/cv.py``'s numpy
twins of its OpenCV calls).

Behavioral parity with src/utils/data_augmentation.py: DexNet-style depth
noise (gamma multiplicative :171, GP additive :186), ellipse dropout on the
valid mask (:132) and ellipse *addition* on the corrupt mask (:95 —
``corrupt_table`` aug), chromatic HLS jitter (:430) and gaussian/motion-blur
RGB noise (:459), ImageNet standardization (:489). All functions take an
explicit ``np.random.Generator`` instead of global numpy RNG state so the
pipeline is reproducible per-sample.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from implicit_depth_torch import constants
from implicit_depth_torch.data import cv


def standardize_image(rgb_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB (H,W,3) -> float32 standardized by ImageNet mean/std."""
    img = rgb_u8.astype(np.float32) / 255.0
    mean = np.asarray(constants.IMG_MEAN, np.float32)
    std = np.asarray(constants.IMG_NORM, np.float32)
    return (img - mean) / std


def unstandardize_image(rgb: np.ndarray) -> np.ndarray:
    mean = np.asarray(constants.IMG_MEAN, np.float32)
    std = np.asarray(constants.IMG_NORM, np.float32)
    return np.clip((rgb * std + mean) * 255.0, 0, 255).astype(np.uint8)


def chromatic_transform(bgr_u8: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Jitter hue/lightness/saturation in HLS space (BGR in/out)."""
    d_h = (rng.random() - 0.5) * 0.1 * 180
    d_l = (rng.random() - 0.5) * 0.2 * 256
    d_s = (rng.random() - 0.5) * 0.2 * 256
    hls = cv.bgr_to_hls(bgr_u8).astype(np.float32)
    hls[..., 0] = (hls[..., 0] + d_h) % 180
    hls[..., 1] = np.clip(hls[..., 1] + d_l, 0, 255)
    hls[..., 2] = np.clip(hls[..., 2] + d_s, 0, 255)
    return cv.hls_to_bgr(hls.astype(np.uint8))


def add_noise(bgr_u8: np.ndarray, rng: np.random.Generator,
              level: float = 0.1) -> np.ndarray:
    """90%: gaussian pixel noise; 10%: axis-aligned motion blur."""
    if rng.random() < 0.9:
        sigma = rng.random() * rng.uniform(0, level) * 256
        gauss = sigma * rng.standard_normal(bgr_u8.shape[:2])
        noisy = bgr_u8.astype(np.float32) + gauss[..., None]
        return np.clip(noisy, 0, 255).astype(np.uint8)
    size = int(rng.choice([3, 5, 7, 9, 11, 15]))
    kernel = np.zeros((size, size), np.float32)
    if rng.random() < 0.5:
        kernel[(size - 1) // 2, :] = 1.0
    else:
        kernel[:, (size - 1) // 2] = 1.0
    return cv.filter2d(bgr_u8, kernel / size)


def _random_ellipses(mask_like: np.ndarray, centers_from: np.ndarray,
                     params: Dict, rng: np.random.Generator) -> np.ndarray:
    """Union of random ellipses centered at rows sampled from
    ``centers_from`` ((N,2) row/col index array)."""
    out = np.zeros_like(mask_like, dtype=np.uint8)
    n = rng.poisson(params["ellipse_dropout_mean"])
    if n == 0 or len(centers_from) == 0:
        return out
    centers = centers_from[rng.choice(len(centers_from), size=n)]
    rx = rng.gamma(params["ellipse_gamma_shape"], params["ellipse_gamma_scale"], n)
    ry = rng.gamma(params["ellipse_gamma_shape"], params["ellipse_gamma_scale"], n)
    angles = rng.integers(0, 360, n)
    for i in range(n):
        cv.fill_ellipse(out, (int(centers[i][1]), int(centers[i][0])),
                        (int(round(rx[i])), int(round(ry[i]))),
                        int(angles[i]), 1)
    return out


def dropout_random_ellipses_4mask(valid_mask: np.ndarray, params: Dict,
                                  rng: np.random.Generator) -> np.ndarray:
    """Zero random ellipses (centered on valid pixels) out of the valid mask."""
    centers = np.argwhere(valid_mask > 0)
    ell = _random_ellipses(valid_mask, centers, params, rng)
    out = valid_mask.copy()
    out[ell == 1] = 0
    return out


def dropout_random_ellipses_4corruptmask(corrupt_mask: np.ndarray, params: Dict,
                                         rng: np.random.Generator) -> np.ndarray:
    """Add random ellipses (centered on non-corrupt pixels) to the corrupt
    mask — the ``corrupt_table`` augmentation."""
    centers = np.argwhere(corrupt_mask == 0)
    ell = _random_ellipses(corrupt_mask, centers, params, rng)
    out = corrupt_mask.copy()
    out[ell == 1] = 1
    return out


def add_noise_to_depth(depth: np.ndarray, params: Dict,
                       rng: np.random.Generator) -> np.ndarray:
    """Single multiplicative gamma noise factor for the whole image."""
    return depth * rng.gamma(params["gamma_shape"], params["gamma_scale"])


def add_noise_to_xyz(xyz: np.ndarray, depth: np.ndarray, params: Dict,
                     rng: np.random.Generator) -> np.ndarray:
    """Approximate GP noise: low-res gaussian field upsampled bicubically,
    added where depth > 0."""
    h, w, c = xyz.shape
    f = params["gp_rescale_factor"]
    small = rng.normal(0.0, params["gaussian_scale"],
                       (h // f, w // f, c)).astype(np.float32)
    field = cv.resize(small, (w, h), cv.INTER_CUBIC)
    # vectorized masked add (boolean fancy-indexing costs ~100 ms at 1080p)
    return xyz + field * (depth > 0)[..., None]
