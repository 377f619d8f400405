"""PLY point-cloud export (binary little-endian; the port's copy of
``implicit_depth_tpu/utils/ply.py``).

Parity: ``save_point_cloud`` (src/utils/vis_utils.py) used by the trainers'
visualization dumps (train_lidf.py:486-581).
"""

from __future__ import annotations

import struct

import numpy as np


def save_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    """xyz: (N, 3) float; rgb: optional (N, 3) in [0,1] or uint8."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    has_rgb = rgb is not None
    if has_rgb:
        rgb = np.asarray(rgb).reshape(-1, 3)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_rgb:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header", ""]

    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        if has_rgb:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"], rec["rgb"] = xyz, rgb
            f.write(rec.tobytes())
        else:
            f.write(xyz.tobytes())


def load_point_cloud(path: str):
    """Minimal reader for round-trip tests."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    n = next(int(l.split()[-1]) for l in header if l.startswith("element vertex"))
    has_rgb = any("uchar red" in l for l in header)
    if has_rgb:
        rec = np.frombuffer(data[end:], dtype=[("xyz", np.float32, 3),
                                               ("rgb", np.uint8, 3)], count=n)
        return rec["xyz"].copy(), rec["rgb"].copy()
    xyz = np.frombuffer(data[end:], np.float32, count=n * 3).reshape(n, 3)
    return xyz.copy(), None
