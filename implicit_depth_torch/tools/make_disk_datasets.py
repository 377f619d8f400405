"""Render procedural scenes into the on-disk layouts of the reference
datasets (the port's counterpart of ``scripts/make_disk_datasets.py``), with
the port's own writers, so that a machine without OpenCV, Pillow or h5py
writes the trees the disk datasets read.

The same seed gives the same scenes as the JAX package's script: the depth
EXRs, masks and HDF5 arrays are the same bits; the JPEGs are the port's
baseline 4:2:0 quality-95 encoding (``data/jpeg.py``), not OpenCV's bytes.

Layouts written (the loaders of ``data/datasets.py`` read them):
  <out>/cleargrasp/cleargrasp-dataset-train/<scene>/
      rgb-imgs/NNNNNNNNN-rgb.jpg
      segmentation-masks/NNNNNNNNN-segmentation-mask.png   (indexed, 255=transparent)
      depth-imgs-rectified/NNNNNNNNN-depth-rectified.exr   (R channel, meters)
      json-files/NNNNNNNNN-masks.json                      (FoV camera)
  <out>/cleargrasp/cleargrasp-dataset-test-val/{synthetic-val,synthetic-test}/...
  <out>/cleargrasp/cleargrasp-dataset-test-val/{real-val,real-test}/{d415,d435}/
      NNNNNNNNN-transparent-rgb-img.jpg / -mask.png /
      -transparent-depth-img.exr / -opaque-depth-img.exr
      camera_intrinsics.yaml
  <out>/omniverse/{train,small_test}/batch0/NNNNN.h5
      rgb_glass, instance_seg, semantic_seg (stacked one-hot), depth
      (disparity = 0.01/m), camera/{pose,focal_length,*_aperture}

Run:
  python -m implicit_depth_torch.tools.make_disk_datasets --out datasets_disk \\
      --n_train 24 --n_val 4 --n_test 4 --src_h 480 --src_w 640
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from implicit_depth_torch.data.exr import write_exr
from implicit_depth_torch.data.hdf5 import write_hdf5
from implicit_depth_torch.data.jpeg import write_jpeg
from implicit_depth_torch.data.seg_io import imwrite_indexed
from implicit_depth_torch.data.synthetic import synthetic_scene_raw


def _transparent_mask(scene) -> np.ndarray:
    m = np.zeros(scene["depth"].shape, bool)
    for om, tr in zip(scene["object_masks"], scene["object_transparent"]):
        if tr:
            m |= om
    return m


def cleargrasp_syn_files(root: str, n: int, rng, src_hw,
                         scene_name="scene0"):
    """One scene dir with n frames (the loader globs <root>/*/rgb-imgs)."""
    h, w = src_hw
    scene_dir = osp.join(root, scene_name)
    for i in range(n):
        s = synthetic_scene_raw(rng, h, w)
        stem = f"{i:09d}"
        yield (osp.join(scene_dir, "rgb-imgs", f"{stem}-rgb.jpg"),
               s["rgb_u8"])
        yield (osp.join(scene_dir, "segmentation-masks",
                        f"{stem}-segmentation-mask.png"),
               (_transparent_mask(s) * 255).astype(np.uint8))
        yield (osp.join(scene_dir, "depth-imgs-rectified",
                        f"{stem}-depth-rectified.exr"), {"R": s["depth"]})
        yield (osp.join(scene_dir, "json-files", f"{stem}-masks.json"),
               {"camera": {"field_of_view": {
                   "x_axis_rads": float(s["fov_x"]),
                   "y_axis_rads": float(s["fov_y"])}},
                "image": {"height_px": h, "width_px": w}})


def cleargrasp_real_files(root: str, n: int, rng, src_hw, camera="d415"):
    h, w = src_hw
    d = osp.join(root, camera)
    # one intrinsics yaml per camera dir (cleargrasp_dataset.py:37-58)
    probe = synthetic_scene_raw(rng, h, w)
    yield (osp.join(d, "camera_intrinsics.yaml"),
           f"fx: {float(probe['fx'])}\nfy: {float(probe['fy'])}\n"
           f"cx: {float(probe['cx'])}\ncy: {float(probe['cy'])}\n")
    for i in range(n):
        s = synthetic_scene_raw(rng, h, w)
        stem = f"{i:09d}"
        tmask = _transparent_mask(s)
        yield osp.join(d, f"{stem}-transparent-rgb-img.jpg"), s["rgb_u8"]
        yield (osp.join(d, f"{stem}-mask.png"),
               (tmask * 255).astype(np.uint8))
        # transparent sensor: depth missing on the transparent object
        yield (osp.join(d, f"{stem}-transparent-depth-img.exr"),
               {"R": (s["depth"] * (~tmask)).astype(np.float32)})
        yield (osp.join(d, f"{stem}-opaque-depth-img.exr"),
               {"R": s["depth"]})


def omniverse_files(root: str, n: int, rng, src_hw, batch="batch0"):
    h, w = src_hw
    for i in range(n):
        s = synthetic_scene_raw(rng, h, w)
        # semantic_seg rows are CLASS planes; the loader derives the
        # per-pixel semantic id = sum(plane_k * (k+1)); transparent == id 2
        sem = np.zeros((2, h, w), np.uint8)
        for om, tr in zip(s["object_masks"], s["object_transparent"]):
            sem[1 if tr else 0] |= om.astype(np.uint8)
        # focal/aperture consistent with the scene's fx/fy
        # (fx = focal/horiz_aperture * W, omniverse_dataset.py:124-142)
        focal = 24.0
        yield osp.join(root, batch, f"{i:05d}.h5"), {
            "rgb_glass": s["rgb_u8"],
            "instance_seg": s["object_masks"].astype(np.uint8),
            "semantic_seg": sem,
            "depth": (0.01 / np.maximum(s["depth"], 1e-6)).astype(
                np.float32),                                 # disparity
            "camera/pose": np.eye(4, dtype=np.float32),
            "camera/focal_length": np.asarray([focal], np.float32),
            "camera/horizontal_aperture": np.asarray(
                [focal * w / float(s["fx"])], np.float32),
            "camera/vertical_aperture": np.asarray(
                [focal * h / float(s["fy"])], np.float32)}


def tree_files(out: str, n_train: int, n_val: int, n_test: int,
               src_hw=(480, 640), seed: int = 0):
    """Every file of the tree as (path, content), in the order the scenes
    are drawn: uint8 RGB for a .jpg, a uint8 mask for a .png, channels for
    an .exr, a dict for .json, text for .yaml, arrays by name for .h5."""
    rng = np.random.default_rng(seed)
    cg = osp.join(out, "cleargrasp")
    test_val = osp.join(cg, "cleargrasp-dataset-test-val")
    omni = osp.join(out, "omniverse")
    yield from cleargrasp_syn_files(osp.join(cg, "cleargrasp-dataset-train"),
                                    n_train, rng, src_hw)
    yield from cleargrasp_syn_files(osp.join(test_val, "synthetic-val"),
                                    n_val, rng, src_hw)
    yield from cleargrasp_syn_files(osp.join(test_val, "synthetic-test"),
                                    n_test, rng, src_hw)
    yield from cleargrasp_real_files(osp.join(test_val, "real-val"), n_val,
                                     rng, src_hw, "d415")
    yield from cleargrasp_real_files(osp.join(test_val, "real-test"), n_test,
                                     rng, src_hw, "d435")
    # the omniverse train split_ratio applies inside the loader; give it
    # enough files that train (90%) and valid (10%) are both non-empty
    yield from omniverse_files(osp.join(omni, "train"), n_train, rng, src_hw)
    yield from omniverse_files(osp.join(omni, "small_test"), n_test, rng,
                               src_hw)


def write_file(path: str, content) -> None:
    """Write one of ``tree_files``' files by its extension."""
    os.makedirs(osp.dirname(path), exist_ok=True)
    ext = osp.splitext(path)[1]
    if ext == ".jpg":
        write_jpeg(path, np.ascontiguousarray(content[..., ::-1]))  # BGR
    elif ext == ".png":
        imwrite_indexed(path, content)
    elif ext == ".exr":
        write_exr(path, content)
    elif ext == ".h5":
        write_hdf5(path, content)
    elif ext == ".json":
        with open(path, "w") as f:
            json.dump(content, f)
    else:
        with open(path, "w") as f:
            f.write(content)


def write_tree(out: str, n_train: int, n_val: int, n_test: int,
               src_hw=(480, 640), seed: int = 0) -> int:
    """Write every split under ``out``; returns the number of files."""
    n = 0
    for path, content in tree_files(out, n_train, n_val, n_test, src_hw,
                                    seed):
        write_file(path, content)
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="datasets_disk")
    ap.add_argument("--n_train", type=int, default=24,
                    help="frames per train source (cg-syn scene / omniverse)")
    ap.add_argument("--n_val", type=int, default=4)
    ap.add_argument("--n_test", type=int, default=4)
    ap.add_argument("--src_h", type=int, default=480)
    ap.add_argument("--src_w", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n_files = write_tree(args.out, args.n_train, args.n_val, args.n_test,
                         (args.src_h, args.src_w), args.seed)
    print(f"wrote {n_files} files under {args.out}/ "
          f"(cleargrasp + omniverse reference layouts)")


if __name__ == "__main__":
    main()
