"""Host-side image standardization (the port's copy of
``implicit_depth_tpu/data/augmentation.py::standardize_image``)."""

from __future__ import annotations

import numpy as np

from implicit_depth_torch import constants


def standardize_image(rgb_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB (H,W,3) -> float32 standardized by ImageNet mean/std."""
    img = rgb_u8.astype(np.float32) / 255.0
    mean = np.asarray(constants.IMG_MEAN, np.float32)
    std = np.asarray(constants.IMG_NORM, np.float32)
    return (img - mean) / std
