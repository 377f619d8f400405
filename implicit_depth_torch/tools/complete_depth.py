"""Complete the depth of RGB-D frames from files (the port's counterpart of
``scripts/complete_depth.py``), served by ``DepthCompleter`` on the card.

  python -m implicit_depth_torch.tools.complete_depth \\
      --lidf_ckpt logs/run_lidf/ckpt --refine_ckpt logs/run_refine/ckpt \\
      --rgb frame-rgb.jpg --depth frame-depth.exr \\
      --fx 577.87 --fy 577.87 --cx 320 --cy 240 --out completed.png

``--depth`` takes .exr (single-channel float meters, the ClearGrasp
format), .npy, or 16-bit .png in millimeters; ``--rgb`` takes .jpg, .png
or .npy (uint8 RGB). ``--out`` writes .npy or 16-bit millimeter .png by
extension. Repeat --rgb/--depth/--out for batches. ``--device`` defaults
to ``cuda``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from implicit_depth_torch.data import cv
from implicit_depth_torch.data.exr import exr_loader
from implicit_depth_torch.data.jpeg import read_jpeg
from implicit_depth_torch.data.png import read_png, read_png_rgb, write_png


def load_depth(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".exr"):
        return exr_loader(path, ndim=1).astype(np.float32)
    d = read_png(path)
    if d.ndim != 2:
        raise ValueError(f"{path}: a depth PNG has one channel, not "
                         f"{d.shape}")
    return d.astype(np.float32) / 1000.0  # 16-bit png, millimeters


def load_rgb(path: str) -> np.ndarray:
    """uint8 RGB, as ``cv2.cvtColor(cv2.imread(path), COLOR_BGR2RGB)``."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.lower().endswith((".jpg", ".jpeg")):
        return cv.bgr_to_rgb(read_jpeg(path))
    return read_png_rgb(path)


def save_depth(path: str, depth: np.ndarray) -> None:
    if path.endswith(".npy"):
        np.save(path, depth.astype(np.float32))
    else:
        write_png(path, (depth * 1000.0).astype(np.uint16))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lidf_ckpt", required=True,
                   help="stage-1 checkpoint dir (<log dir>/ckpt)")
    p.add_argument("--refine_ckpt", default=None,
                   help="optional stage-2 checkpoint dir")
    p.add_argument("--cfg_paths", nargs="*", default=[],
                   help="config yamls (defaults otherwise)")
    p.add_argument("--ckpt_name", default="best_network")
    p.add_argument("--rgb", action="append", required=True)
    p.add_argument("--depth", action="append", required=True)
    p.add_argument("--fx", type=float, required=True)
    p.add_argument("--fy", type=float, required=True)
    p.add_argument("--cx", type=float, required=True)
    p.add_argument("--cy", type=float, required=True)
    p.add_argument("--out", action="append", required=True,
                   help="output path per frame (.npy or .png)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not (len(args.rgb) == len(args.depth) == len(args.out)):
        p.error("--rgb/--depth/--out counts must match")

    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    cfg = load_config(*args.cfg_paths, overrides={"mask_type": "all"})
    dc = DepthCompleter.from_checkpoint(
        args.lidf_ckpt, refine_ckpt_dir=args.refine_ckpt, cfg=cfg,
        ckpt_name=args.ckpt_name, batch_size=len(args.rgb),
        device=args.device)
    rgbs = [load_rgb(r) for r in args.rgb]
    depths = [load_depth(d) for d in args.depth]
    intr = [(args.fx, args.fy, args.cx, args.cy)] * len(rgbs)
    out = dc.complete_batch(rgbs, depths, intr)
    for i, path in enumerate(args.out):
        save_depth(path, np.asarray(out["depth"][i]))
        miss = int((depths[i] == 0).sum())
        print(f"{path}: completed {miss} missing pixels")


if __name__ == "__main__":
    sys.exit(main())
