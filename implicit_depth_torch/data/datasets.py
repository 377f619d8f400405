"""Host-side datasets: ClearGrasp synthetic / real, Omniverse, Mixed (the
port's copy of ``implicit_depth_tpu/data/datasets.py``).

Behavioral parity with src/datasets/*.py; every sample is a dict of numpy
arrays (NHWC images, floats) matching the contract consumed by
``prepare_inputs``:

  rgb (H,W,3) standardized · depth / depth_corrupt (H,W) · xyz / xyz_corrupt
  (H,W,3) · corrupt_mask / valid_mask (H,W) float{0,1} · fx fy cx cy scalars ·
  item_path str

Each dataset gets an integer-seeded per-item RNG (base_seed + epoch*len +
idx) so augmentation is reproducible and independent of worker scheduling —
the reference relies on global numpy state instead.

The disk datasets read JPEG, PNG, EXR and HDF5 files and resize images
with the port's own numpy codecs and OpenCV twins (``data/jpeg.py``,
``png.py``, ``exr.py``, ``hdf5.py``, ``cv.py``), so that they load without
OpenCV, Pillow or h5py.
"""

from __future__ import annotations

import json
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

from implicit_depth_torch.config import load_yaml
from implicit_depth_torch.data import augmentation as aug
from implicit_depth_torch.data import cv
from implicit_depth_torch.data.exr import exr_loader
from implicit_depth_torch.data.hdf5 import read_hdf5
from implicit_depth_torch.data.jpeg import read_jpeg
from implicit_depth_torch.data.png import read_png_gray
from implicit_depth_torch.data.seg_io import imread_indexed
from implicit_depth_torch.geometry.camera import compute_xyz_np


def _connected_components(binary: np.ndarray) -> np.ndarray:
    """4-connected labeling (scipy.ndimage.label semantics used by the
    reference, cleargrasp_synthetic_dataset.py:105). Uses the native C++
    runtime when built, scipy otherwise."""
    from implicit_depth_torch import native
    lab = native.connected_components(binary)
    if lab is not None:
        return lab
    from scipy.ndimage import label
    lab, _ = label(binary)
    return lab


def _process_rgb(bgr: np.ndarray, wh, train_aug: bool,
                 rng: np.random.Generator) -> np.ndarray:
    if train_aug and rng.random() > 0.2:
        bgr = aug.chromatic_transform(bgr, rng)
        bgr = aug.add_noise(bgr, rng)
    bgr = cv.resize(bgr, wh, cv.INTER_LINEAR)
    rgb = cv.bgr_to_rgb(bgr)
    return aug.standardize_image(rgb)


class ClearGraspSynthetic:
    """src/datasets/cleargrasp_synthetic_dataset.py:19-269."""

    def __init__(self, subdirs: Sequence[str], exp_type: str, params: Dict,
                 base_seed: int = 0):
        self.exp_type = exp_type
        self.params = dict(params)
        if exp_type != "train":
            self.params["use_data_augmentation"] = False
        self.base_seed = base_seed

        image_paths: List[str] = []
        for d in subdirs:
            image_paths += sorted(glob(osp.join(d, "*", "rgb-imgs", "*-rgb.jpg")))
        split = int(len(image_paths) * self.params["split_ratio"])
        if exp_type == "train":
            image_paths = image_paths[:split]
        self.image_paths = image_paths

    def __len__(self):
        return len(self.image_paths)

    @staticmethod
    def _aux_path(rgb_path: str, folder: str, suffix: str) -> str:
        return rgb_path.replace("rgb-imgs", folder).replace("-rgb.jpg", suffix)

    def _cam_params(self, json_path: str, img_hw) -> Dict[str, float]:
        meta = json.load(open(json_path))
        cam = meta.get("camera", {})
        fov = cam.get("field_of_view", {})
        fov_x = fov.get("x_axis_rads", 1.2112585306167603)
        fov_y = fov.get("y_axis_rads", 0.7428327202796936)
        img = meta.get("image", {})
        img_h = img.get("height_px", img_hw[0])
        img_w = img.get("width_px", img_hw[1])
        return {
            "fx": img_w * 0.5 / np.tan(fov_x * 0.5),
            "fy": img_h * 0.5 / np.tan(fov_y * 0.5),
            "cx": img_w * 0.5,
            "cy": img_h * 0.5,
        }

    def __getitem__(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        p = self.params
        w, h = p["img_width"], p["img_height"]
        rng = np.random.default_rng(self.base_seed + epoch * len(self) + idx)
        train_aug = self.exp_type == "train" and p["use_data_augmentation"]

        rgb_path = self.image_paths[idx]
        bgr = read_jpeg(rgb_path)
        src_h, src_w = bgr.shape[:2]
        scale = (w / src_w, h / src_h)
        rgb = _process_rgb(bgr, (w, h), train_aug, rng)

        mask = imread_indexed(self._aux_path(rgb_path, "segmentation-masks",
                                             "-segmentation-mask.png"))
        if mask.ndim == 3:
            mask = mask[..., 0]
        labels = _connected_components(mask == 255)
        labels = cv.resize(labels.astype(np.int32), (w, h), cv.INTER_NEAREST)
        corrupt_mask = (labels != 0).astype(np.float32)

        cam = self._cam_params(self._aux_path(rgb_path, "json-files", "-masks.json"),
                               (src_h, src_w))

        depth = exr_loader(self._aux_path(rgb_path, "depth-imgs-rectified",
                                          "-depth-rectified.exr"), 1)
        inp_depth = depth.copy()
        if train_aug and p.get("depth_aug"):
            inp_depth = aug.add_noise_to_depth(inp_depth, p, rng)
        xyz = compute_xyz_np(depth, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        inp_xyz = compute_xyz_np(inp_depth, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        if train_aug and p.get("depth_aug"):
            inp_xyz = aug.add_noise_to_xyz(inp_xyz, inp_depth, p, rng)
        rs = lambda im: cv.resize(im, (w, h), cv.INTER_NEAREST)
        depth, xyz = rs(depth), rs(xyz)
        inp_depth, inp_xyz = rs(inp_depth), rs(inp_xyz)
        depth_corrupt = inp_depth * (1 - corrupt_mask)
        xyz_corrupt = inp_xyz * (1 - corrupt_mask)[..., None]

        valid_mask = 1 - corrupt_mask
        if train_aug and rng.random() > 0.2:
            valid_mask = aug.dropout_random_ellipses_4mask(valid_mask, p, rng)
        if self.exp_type == "train":
            if p.get("corrupt_table"):
                corrupt_mask = aug.dropout_random_ellipses_4corruptmask(
                    corrupt_mask, p, rng)
            elif p.get("corrupt_all_pix"):
                corrupt_mask = np.ones_like(corrupt_mask)

        return {
            "rgb": rgb.astype(np.float32),
            "depth": depth.astype(np.float32),
            "depth_corrupt": depth_corrupt.astype(np.float32),
            "xyz": xyz.astype(np.float32),
            "xyz_corrupt": xyz_corrupt.astype(np.float32),
            "corrupt_mask": corrupt_mask.astype(np.float32),
            "valid_mask": valid_mask.astype(np.float32),
            "fx": np.float32(cam["fx"] * scale[0]),
            "fy": np.float32(cam["fy"] * scale[1]),
            "cx": np.float32(cam["cx"] * scale[0]),
            "cy": np.float32(cam["cy"] * scale[1]),
            "item_path": rgb_path,
        }


class ClearGraspReal:
    """src/datasets/cleargrasp_dataset.py:19-206 (eval only)."""

    def __init__(self, subdirs: Sequence[str], exp_type: str, params: Dict,
                 base_seed: int = 0):
        assert exp_type != "train", "real ClearGrasp has no train split"
        self.exp_type = exp_type
        self.params = dict(params, use_data_augmentation=False)
        self.base_seed = base_seed
        self.image_paths: List[str] = []
        self.intrinsics: Dict[str, Dict] = {}
        for d in subdirs:
            for camera in ("d415", "d435"):
                dirpath = osp.join(d, camera)
                if not osp.isdir(dirpath):
                    continue
                self.image_paths += sorted(
                    glob(osp.join(dirpath, "*-transparent-rgb-img.jpg")))
                if camera not in self.intrinsics:
                    with open(osp.join(dirpath, "camera_intrinsics.yaml")) as f:
                        self.intrinsics[camera] = load_yaml(f.read())

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        p = self.params
        w, h = p["img_width"], p["img_height"]
        rng = np.random.default_rng(self.base_seed + idx)

        rgb_path = self.image_paths[idx]
        bgr = read_jpeg(rgb_path)
        src_h, src_w = bgr.shape[:2]
        scale = (w / src_w, h / src_h)
        rgb = _process_rgb(bgr, (w, h), False, rng)

        mask = imread_indexed(rgb_path.replace("-transparent-rgb-img.jpg", "-mask.png"))
        if mask.ndim == 3:
            mask = mask[..., 0]
        labels = _connected_components(mask == 255)
        labels = cv.resize(labels.astype(np.int32), (w, h), cv.INTER_NEAREST)
        corrupt_mask = (labels != 0).astype(np.float32)

        cam = self.intrinsics["d415" if "d415" in rgb_path else "d435"]
        fx, fy, cx, cy = (float(cam["fx"]), float(cam["fy"]),
                          float(cam["cx"]), float(cam["cy"]))

        rs = lambda im: cv.resize(im, (w, h), cv.INTER_NEAREST)
        d_corrupt = exr_loader(
            rgb_path.replace("-transparent-rgb-img.jpg", "-transparent-depth-img.exr"), 1)
        d_corrupt = np.nan_to_num(d_corrupt, nan=0.0)
        xyz_corrupt = rs(compute_xyz_np(d_corrupt, fx, fy, cx, cy))
        d_corrupt = rs(d_corrupt)

        valid_mask = (1 - corrupt_mask).copy()
        valid_mask[d_corrupt == 0] = 0

        d_gt = exr_loader(
            rgb_path.replace("-transparent-rgb-img.jpg", "-opaque-depth-img.exr"), 1)
        d_gt = np.nan_to_num(d_gt, nan=0.0)
        xyz_gt = rs(compute_xyz_np(d_gt, fx, fy, cx, cy))
        d_gt = rs(d_gt)

        parts = rgb_path.split("/")
        item_path = f"{parts[-3]}_{parts[-2]}_{parts[-1].split('-')[0]}"
        return {
            "rgb": rgb.astype(np.float32),
            "depth": d_gt.astype(np.float32),
            "depth_corrupt": d_corrupt.astype(np.float32),
            "xyz": xyz_gt.astype(np.float32),
            "xyz_corrupt": xyz_corrupt.astype(np.float32),
            "corrupt_mask": corrupt_mask.astype(np.float32),
            "valid_mask": valid_mask.astype(np.float32),
            "fx": np.float32(fx * scale[0]),
            "fy": np.float32(fy * scale[1]),
            "cx": np.float32(cx * scale[0]),
            "cy": np.float32(cy * scale[1]),
            "item_path": item_path,
        }


# the datasets of an Omniverse scene the loader reads, as the JAX package's
# loader reads them through h5py (implicit_depth_tpu/data/datasets.py):
# the file's other datasets are not decoded
OMNIVERSE_KEYS = ("rgb_glass", "instance_seg", "semantic_seg", "depth",
                  "camera/focal_length", "camera/horizontal_aperture",
                  "camera/vertical_aperture")


class Omniverse:
    """src/datasets/omniverse_dataset.py:18-245 (h5 scenes)."""

    def __init__(self, root_dir: str, exp_type: str, params: Dict,
                 base_seed: int = 0):
        self.exp_type = exp_type
        self.params = dict(params)
        if exp_type != "train":
            self.params["use_data_augmentation"] = False
        self.base_seed = base_seed
        h5_paths = sorted(glob(osp.join(root_dir, "*", "*.h5")))
        split = int(len(h5_paths) * self.params["split_ratio"])
        if exp_type == "train":
            self.h5_paths = h5_paths[:split]
        elif exp_type == "valid":
            self.h5_paths = h5_paths[split:]
        else:
            self.h5_paths = h5_paths

    def __len__(self):
        return len(self.h5_paths)

    def _corrupt_mask(self, inst, sem, n_inst, rng, corrupt_all,
                      ratio_low=0.3, ratio_high=0.7) -> np.ndarray:
        out = np.zeros(inst.shape, np.float32)
        if self.exp_type == "train":
            if corrupt_all:
                obj_ids = np.arange(n_inst)
            else:
                k = rng.integers(1, n_inst + 1)
                obj_ids = rng.choice(n_inst, k, replace=False)
        else:
            obj_ids = np.arange(n_inst)
        for oid in obj_ids:
            oid = oid + 1
            nz = np.argwhere(inst == oid)
            if len(nz) == 0:
                continue
            transparent = sem[nz[0, 0], nz[0, 1]] == 2
            if transparent:
                sel = nz
            elif self.exp_type == "train":
                ratio = rng.random() * (ratio_high - ratio_low) + ratio_low
                n = int(len(nz) * ratio)
                start = rng.integers(0, max(len(nz) - n, 1))
                sel = nz[start:start + n]
            else:
                continue
            out[sel[:, 0], sel[:, 1]] = 1
        return out

    def __getitem__(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        p = self.params
        w, h = p["img_width"], p["img_height"]
        rng = np.random.default_rng(self.base_seed + epoch * len(self) + idx)
        train_aug = self.exp_type == "train" and p["use_data_augmentation"]

        f = read_hdf5(self.h5_paths[idx], OMNIVERSE_KEYS)
        rgb_raw = f["rgb_glass"]
        src_h, src_w = rgb_raw.shape[:2]
        scale = (w / src_w, h / src_h)
        bgr = cv.rgb_to_bgr(rgb_raw)
        rgb = _process_rgb(bgr, (w, h), train_aug, rng)

        inst_seg = f["instance_seg"]
        n_inst = inst_seg.shape[0]
        ids = np.arange(1, n_inst + 1).reshape(-1, 1, 1)
        inst = np.sum(inst_seg * ids, 0).astype(np.uint8)
        sem_seg = f["semantic_seg"]
        sem_ids = np.arange(1, sem_seg.shape[0] + 1).reshape(-1, 1, 1)
        sem = np.sum(sem_seg * sem_ids, 0).astype(np.uint8)
        rs = lambda im: cv.resize(im, (w, h), cv.INTER_NEAREST)
        inst, sem = rs(inst), rs(sem)

        corrupt_mask = self._corrupt_mask(inst, sem, n_inst, rng,
                                          corrupt_all=p["omni_corrupt_all"])

        focal = f["camera/focal_length"][0]
        ha = f["camera/horizontal_aperture"][0]
        va = f["camera/vertical_aperture"][0]
        fx = focal / ha * src_w
        fy = focal / va * src_h
        cx, cy = src_w // 2, src_h // 2

        disparity = f["depth"]
        depth = np.clip(1.0 / (disparity + 1e-8) * 0.01, 0,
                        p.get("max_depth", 4))

        inp_depth = depth.copy()
        if train_aug and p.get("depth_aug"):
            inp_depth = aug.add_noise_to_depth(inp_depth, p, rng)
        xyz = compute_xyz_np(depth, fx, fy, cx, cy)
        inp_xyz = compute_xyz_np(inp_depth, fx, fy, cx, cy)
        if train_aug and p.get("depth_aug"):
            inp_xyz = aug.add_noise_to_xyz(inp_xyz, inp_depth, p, rng)
        rs = lambda im: cv.resize(im, (w, h), cv.INTER_NEAREST)
        depth, xyz, inp_depth, inp_xyz = rs(depth), rs(xyz), rs(inp_depth), rs(inp_xyz)
        depth_corrupt = inp_depth * (1 - corrupt_mask)
        xyz_corrupt = inp_xyz * (1 - corrupt_mask)[..., None]

        valid_mask = 1 - corrupt_mask.copy()
        if train_aug and rng.random() > 0.2:
            valid_mask = aug.dropout_random_ellipses_4mask(valid_mask, p, rng)
        if self.exp_type == "train":
            if p.get("corrupt_table"):
                corrupt_mask = aug.dropout_random_ellipses_4corruptmask(
                    corrupt_mask, p, rng)
            elif p.get("corrupt_all_pix"):
                corrupt_mask = np.ones_like(corrupt_mask)

        return {
            "rgb": rgb.astype(np.float32),
            "depth": depth.astype(np.float32),
            "depth_corrupt": depth_corrupt.astype(np.float32),
            "xyz": xyz.astype(np.float32),
            "xyz_corrupt": xyz_corrupt.astype(np.float32),
            "corrupt_mask": corrupt_mask.astype(np.float32),
            "valid_mask": valid_mask.astype(np.float32),
            "fx": np.float32(fx * scale[0]),
            "fy": np.float32(fy * scale[1]),
            "cx": np.float32(cx * scale[0]),
            "cy": np.float32(cy * scale[1]),
            "item_path": self.h5_paths[idx],
        }


class MixedDataset:
    """Concatenation by index offset (src/datasets/mixed_dataset.py:18-45)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self._cum[-1] if self._cum else 0

    def __getitem__(self, idx: int, epoch: int = 0):
        lo = 0
        for d, hi in zip(self.datasets, self._cum):
            if idx < hi:
                return d.__getitem__(idx - lo, epoch)
            lo = hi
        raise IndexError(idx)


class SyntheticDataset:
    """Procedural scenes (data/synthetic.py) exposed with the same API —
    lets train/eval/bench run without the real datasets on disk."""

    def __init__(self, length: int, params: Dict, base_seed: int = 0):
        from implicit_depth_torch.data.synthetic import synthetic_sample
        self._gen = synthetic_sample
        self.length = length
        self.h = params["img_height"]
        self.w = params["img_width"]
        self.base_seed = base_seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int, epoch: int = 0):
        rng = np.random.default_rng(self.base_seed + epoch * self.length + idx)
        s = self._gen(rng, self.h, self.w)
        s["item_path"] = f"synthetic/{idx:06d}"
        return s


class PredMaskDataset:
    """Adds a ``pred_mask`` key: the transparent-region prediction of an
    EXTERNAL segmentation model, consumed by ``mask_type='pred'`` eval
    (≙ reference pipeline.py:117-129, where pred_mask is passed into
    ``LIDF.forward``). Masks are read from ``pred_mask_dir`` (one PNG per
    item, matched by sanitized item_path, nearest-resized to the sample);
    with no directory the GT ``corrupt_mask`` is used — i.e. a perfect
    segmentor, the upper bound the reference's external masks approximate."""

    def __init__(self, base, pred_mask_dir: Optional[str] = None):
        self.base = base
        self.pred_mask_dir = pred_mask_dir

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        s = self.base.__getitem__(idx, epoch)
        pm = None
        if self.pred_mask_dir:
            name = str(s.get("item_path", idx)).replace("/", "_").replace("\\", "_")
            name = osp.splitext(name)[0]
            for cand in (osp.join(self.pred_mask_dir, name + ".png"),
                         osp.join(self.pred_mask_dir, f"{idx:06d}.png")):
                if osp.exists(cand):
                    m = read_png_gray(cand)
                    h, w = s["corrupt_mask"].shape
                    m = cv.resize(m, (w, h), cv.INTER_NEAREST)
                    pm = (m > 127).astype(np.float32)
                    break
        if pm is None:
            pm = np.asarray(s["corrupt_mask"], np.float32)
        s["pred_mask"] = pm
        return s


def get_dataset(cfg_dataset, exp_type: str, obj_type: str = "known",
                base_seed: int = 0):
    """Dataset factory ≙ the reference's per-module get_dataset functions
    (cleargrasp_synthetic_dataset.py:253, cleargrasp_dataset.py:188,
    omniverse_dataset.py:231, trainers wiring train_lidf.py:124-201)."""
    params = cfg_dataset.to_dict() if hasattr(cfg_dataset, "to_dict") else dict(cfg_dataset)
    dtype = params.get("type", "synthetic")
    cg_root = params.get("cleargrasp_root_dir")
    omni_root = params.get("omniverse_root_dir")

    def maybe_pred_mask(ds):
        if params.get("provide_pred_mask") or params.get("pred_mask_dir"):
            return PredMaskDataset(ds, params.get("pred_mask_dir"))
        return ds

    if dtype == "synthetic":
        return maybe_pred_mask(
            SyntheticDataset(params.get("synthetic_len", 64), params, base_seed))

    def cg_syn():
        if exp_type == "train":
            sub = [osp.join(cg_root, "cleargrasp-dataset-train")]
        elif obj_type == "novel":
            sub = [osp.join(cg_root, "cleargrasp-dataset-test-val", "synthetic-test")]
        else:
            sub = [osp.join(cg_root, "cleargrasp-dataset-test-val", "synthetic-val")]
        return ClearGraspSynthetic(sub, exp_type, params, base_seed)

    def cg_real():
        sub = [osp.join(cg_root, "cleargrasp-dataset-test-val",
                        "real-test" if obj_type == "novel" else "real-val")]
        return ClearGraspReal(sub, exp_type, params, base_seed)

    def omni():
        sub = osp.join(omni_root, "small_test" if exp_type == "test" else "train")
        return Omniverse(sub, exp_type, params, base_seed)

    if dtype == "cleargrasp_synthetic":
        return maybe_pred_mask(cg_syn())
    if dtype == "cleargrasp_real":
        return maybe_pred_mask(cg_real())
    if dtype == "omniverse":
        return maybe_pred_mask(omni())
    if dtype == "mixed":
        return maybe_pred_mask(MixedDataset([cg_syn(), omni()]))
    raise ValueError(f"unknown dataset type {dtype!r}")
