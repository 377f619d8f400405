"""Serving API: one-call two-stage depth completion of RGB-D frames
(counterpart of ``implicit_depth_tpu/infer.py::DepthCompleter``)::

    from implicit_depth_torch.infer import DepthCompleter

    dc = DepthCompleter(cfg, lidf=lidf_model, refine=refine_model)
    # or trained weights, from the trainers' checkpoint directories:
    dc = DepthCompleter.from_checkpoint("logs/lidf/ckpt",
                                        refine_ckpt_dir="logs/refine/ckpt")
    out = dc.complete(rgb_u8, depth_m, (fx, fy, cx, cy))
    out["depth"]       # completed depth at the input resolution (H0, W0)
    out["depth_pred"]  # the model's predicted depth at every pixel (h, w)

Per frame: the frame is resized on the host to the model resolution
(bilinear RGB, nearest depth, intrinsics rescaled), copied to the device as
plain float32 tensors (pinned, non-blocking), run through prepare_inputs,
the LIDF stage 1 and ``refine.forward_times`` RefineNet iterations, and the
completed depth is composed on the device; one readback brings both images
back. Input depth passes through bit for bit wherever it is present.
Entry points run on ``cuda`` unless ``device="cpu"`` is asked for.

Several cards serve one process as a ``(data, rays)`` grid (``mesh=``, the
counterpart of the JAX ``DepthCompleter``'s mesh)::

    dc = DepthCompleter(cfg, lidf=lidf_model, refine=refine_model,
                        batch_size=2, mesh="auto")   # every visible card
    dc = DepthCompleter(cfg, lidf=lidf_model, batch_size=2,
                        mesh=[["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]])

The geometry stage runs on the grid's first device over the whole batch
(the valid points are the one-card draw); each device runs the stage-1
trunk of its row's frames and decodes its block of their rays (K1, or K6
in the ``global`` and dense modes: the ``global`` budget is chosen over the
whole batch, and each device decodes the selected rows of its block); the
blocks are joined on the first device, which runs the RefineNet's
iterations whole (K4, K5) and composes the depth.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from implicit_depth_torch.config import Config, load_config
from implicit_depth_torch.data import cv
from implicit_depth_torch.data.augmentation import standardize_image
from implicit_depth_torch.geometry.camera import compute_xyz
from implicit_depth_torch.models.lidf import (
    RAY_SPLIT_KEYS,
    LIDFModel,
    prepare_inputs,
)
from implicit_depth_torch.models.refine import RefineModel, refine_forward
from implicit_depth_torch.parallel.mesh import ray_block
from implicit_depth_torch.utils import profiling

Intrinsics = Union[Tuple[float, float, float, float], Sequence[float]]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device without a card
    (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device "
                           "is available")
    return dev


Mesh = Union[None, str, Sequence[Sequence[Union[str, torch.device]]]]


def device_grid(mesh: Mesh, batch_size: int
                ) -> Optional[List[List[torch.device]]]:
    """``mesh`` as a (data, rays) grid of devices: None stays None;
    ``"auto"`` puts every visible card on it, ``data = gcd(batch_size,
    cards)`` and ``rays = cards // data`` (the JAX ``DepthCompleter``'s
    rule); a nested list is taken as it is. Raises for a card asked for
    without one, a ragged grid, or a batch the data axis does not
    divide."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh {mesh!r}: None, 'auto' or a (data, "
                             "rays) nested list of devices")
        resolve_device("cuda")
        n = torch.cuda.device_count()
        data = math.gcd(batch_size, n)
        rays = n // data
        return [[torch.device("cuda", d * rays + r) for r in range(rays)]
                for d in range(data)]
    grid = [[resolve_device(d) for d in row] for row in mesh]
    if not grid or not grid[0] or any(len(row) != len(grid[0])
                                      for row in grid):
        raise ValueError("mesh: a (data, rays) nested list of devices, "
                         "every row as long")
    if batch_size % len(grid):
        raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                         f"mesh's data axis {len(grid)}")
    return grid


class DepthCompleter:
    """Two-stage (LIDF + optional RefineNet) depth completion as a service.

    ``lidf`` / ``refine`` are the port's modules with their weights (random
    from ``builder``, loaded with ``weights.lidf_from_jax``, or trained:
    :meth:`from_checkpoint`). The models
    are moved to ``device`` and put in eval mode. ``batch_size`` is the most
    frames one :meth:`complete_batch` call takes. ``mesh`` (None, ``"auto"``
    or a (data, rays) nested list of devices: :func:`device_grid`) serves
    on a grid of devices, ``device`` then its first; the stage-1 model is
    copied to each other device once."""

    def __init__(self, cfg: Optional[Config] = None, *, lidf: LIDFModel,
                 refine: Optional[RefineModel] = None, batch_size: int = 1,
                 device: Union[str, torch.device] = "cuda",
                 mesh: Mesh = None):
        self.grid = device_grid(mesh, int(batch_size))
        self.device = (self.grid[0][0] if self.grid
                       else resolve_device(device))
        self.cfg = cfg if cfg is not None else load_config(
            overrides={"mask_type": "all"})
        self.h = int(self.cfg.dataset.img_height)
        self.w = int(self.cfg.dataset.img_width)
        self.batch_size = int(batch_size)
        self.static = lidf.static
        self.lidf = lidf.to(self.device).eval()
        self.refine = None if refine is None else refine.to(self.device).eval()
        self.forward_times = int(self.cfg.refine.forward_times)
        self.use_all_pix = bool(self.cfg.refine.use_all_pix)
        self._lidf_on = {self.device: self.lidf}
        for dev in {d for row in (self.grid or []) for d in row}:
            if dev not in self._lidf_on:
                self._lidf_on[dev] = copy.deepcopy(self.lidf).to(dev).eval()

    @classmethod
    def from_checkpoint(cls, lidf_ckpt_dir: str,
                        refine_ckpt_dir: Optional[str] = None,
                        cfg: Optional[Config] = None,
                        ckpt_name: str = "best_network", batch_size: int = 1,
                        device: Union[str, torch.device] = "cuda",
                        mesh: Mesh = None) -> "DepthCompleter":
        """Serve trained weights from the checkpoint directories of the
        trainers (``train/checkpoint.py``): the stage-1 model and, when
        ``refine_ckpt_dir`` is given, the stage-2 model, each built from
        ``cfg`` and loaded by ``restore_params_only``. ``ckpt_name`` falls
        back to ``latest_network`` where a directory has no such
        checkpoint. ``mesh`` as the constructor takes it."""
        from implicit_depth_torch.builder import (
            build_lidf,
            build_refine,
            build_static,
        )
        from implicit_depth_torch.train.checkpoint import (
            LATEST,
            restore_params_only,
        )

        cfg = cfg if cfg is not None else load_config(
            overrides={"mask_type": "all"})

        def pick(d):
            named = os.path.join(d, ckpt_name)
            return ckpt_name if (os.path.isdir(named)
                                 or os.path.isdir(named + ".prev")) else LATEST

        h, w = cfg.dataset.img_height, cfg.dataset.img_width
        static = build_static(cfg, n_rays=h * w)
        lidf = restore_params_only(lidf_ckpt_dir, build_lidf(cfg, static),
                                   pick(lidf_ckpt_dir))
        refine = None
        if refine_ckpt_dir is not None:
            refine = restore_params_only(refine_ckpt_dir,
                                         build_refine(cfg, static),
                                         pick(refine_ckpt_dir))
        return cls(cfg, lidf=lidf, refine=refine, batch_size=batch_size,
                   device=device, mesh=mesh)

    # -- device forward -----------------------------------------------------
    @torch.inference_mode()
    @profiling.spanned("infer.forward")
    def forward(self, batch: Dict[str, torch.Tensor], seed: int = 0,
                valid_idx: Optional[torch.Tensor] = None):
        """Two-stage forward of a device batch dict -> (completed (B, h, w),
        pred_z (B, h, w)), both on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        inputs = prepare_inputs(self.static, batch, train=False,
                                mask_type="all", generator=gen,
                                valid_idx=valid_idx)
        out = self.lidf(inputs) if self.grid is None else self._on_grid(inputs)
        pred = out["pred_pos"]
        if self.refine is not None:
            inject = None
            if not self.use_all_pix:  # inject zero-input-depth pixels only
                b = batch["depth_corrupt"].shape[0]
                inject = batch["depth_corrupt"].reshape(b, -1) == 0
            pred = refine_forward(self.refine, inputs, out,
                                  self.forward_times, inject_mask=inject)
        pred_z = pred[..., 2].reshape(-1, self.h, self.w)
        depth_in = batch["depth_corrupt"]
        return torch.where(depth_in == 0, pred_z, depth_in), pred_z

    def _on_grid(self, inputs: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Stage 1 on the grid: device (d, i) takes the frames of data row
        d and block i of their rays (``parallel/mesh.py::ray_block``), as
        contiguous copies, run with its card the current device (a kernel
        launches on the current device's streams); its per-ray outputs are
        joined on the first device, the rays block by block, then the
        rows."""
        data, rays = len(self.grid), len(self.grid[0])
        b, r = inputs["pair_valid"].shape[:2]
        rows_b = b // data
        pair_valid = {}
        rows = []
        for d, row in enumerate(self.grid):
            rs = slice(d * rows_b, (d + 1) * rows_b)
            blocks = []
            for i, dev in enumerate(row):
                s, e = ray_block(r, rays, i)
                sub = {k: (v[rs, s:e] if k in RAY_SPLIT_KEYS else v[rs]
                           ).contiguous().to(dev) for k, v in inputs.items()}
                model = self._lidf_on[dev]
                whole = None
                if model.decode_mode == "global":
                    if dev not in pair_valid:
                        pair_valid[dev] = inputs["pair_valid"].to(dev)
                    whole = (pair_valid[dev], d * rows_b, s)
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    out = model(sub, whole=whole)
                blocks.append({k: v.to(self.device) for k, v in out.items()
                               if k not in ("feat_map", "vox_feat")})
            rows.append({k: torch.cat([o[k] for o in blocks], 1)
                         for k in blocks[0]})
        return {k: torch.cat([o[k] for o in rows], 0) for k in rows[0]}

    # -- host-side frame handling ------------------------------------------
    def _prep_frame(self, rgb: np.ndarray, depth: np.ndarray,
                    intr: Intrinsics):
        """Resize a frame to the model resolution -> (rgb (h, w, 3)
        standardized, depth (h, w), (fx, fy, cx, cy)), float32. The resizes
        are OpenCV's (``data/cv.py``): uint8 RGB stays uint8 through its
        bilinear resize, other RGB is resized as float32."""
        fx, fy, cx, cy = (float(v) for v in intr)
        h0, w0 = depth.shape[:2]
        is_u8 = rgb.dtype == np.uint8
        if (h0, w0) != (self.h, self.w):
            if not is_u8:
                rgb = np.asarray(rgb, np.float32)
            rgb = cv.resize(rgb, (self.w, self.h), cv.INTER_LINEAR)
            depth = cv.resize(depth, (self.w, self.h), cv.INTER_NEAREST)
            fx *= self.w / w0
            cx *= self.w / w0
            fy *= self.h / h0
            cy *= self.h / h0
        if is_u8:
            rgb = standardize_image(rgb)
        return (np.asarray(rgb, np.float32), np.asarray(depth, np.float32),
                (fx, fy, cx, cy))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @profiling.spanned("infer.device_batch")
    def device_batch(self, rgbs, depths, intrinsics) -> Dict[str, torch.Tensor]:
        """Host frames -> the device batch dict of :meth:`forward`, padded to
        ``batch_size`` by repeating the last frame."""
        with profiling.span("infer.prep_frames"):
            frames = [self._prep_frame(np.asarray(r), np.asarray(d), i)
                      for r, d, i in zip(rgbs, depths, intrinsics)]
        frames += [frames[-1]] * (self.batch_size - len(frames))
        with profiling.span("infer.h2d"):
            rgb = self._to_device(np.stack([f[0] for f in frames]))
            depth = self._to_device(np.stack([f[1] for f in frames]))
            fx, fy, cx, cy = self._to_device(
                np.asarray([f[2] for f in frames], np.float32).T.copy())
        return {
            "rgb": rgb,
            "depth_corrupt": depth,
            "xyz_corrupt": compute_xyz(depth, fx, fy, cx, cy),
            # the GT placeholder: backproject(0) = 0 (no loss runs here)
            "xyz": torch.zeros(depth.shape + (3,), device=self.device),
            "corrupt_mask": (depth == 0).float(),
            "valid_mask": (depth != 0).float(),
            "fx": fx, "fy": fy, "cx": cx, "cy": cy,
        }

    # -- public API ---------------------------------------------------------
    def complete(self, rgb: np.ndarray, depth: np.ndarray,
                 intrinsics: Intrinsics, seed: int = 0) -> Dict[str, np.ndarray]:
        """Complete one RGB-D frame.

        rgb: (H0, W0, 3) uint8 (standardized internally) or pre-standardized
        float32; depth: (H0, W0) float meters, 0 at missing pixels;
        intrinsics: (fx, fy, cx, cy) at the input resolution.

        Returns {"depth": completed (H0, W0) — input depth where present,
        prediction where missing; "depth_pred": the model's predicted depth
        at every pixel, model resolution (h, w)}."""
        out = self.complete_batch([rgb], [depth], [intrinsics], seed=seed)
        return {"depth": out["depth"][0], "depth_pred": out["depth_pred"][0]}

    @profiling.spanned("infer.complete_batch")
    def complete_batch(self, rgbs, depths, intrinsics,
                       seed: int = 0) -> Dict[str, np.ndarray]:
        """Batched :meth:`complete` of at most ``batch_size`` frames."""
        n = len(rgbs)
        if not (0 < n <= self.batch_size):
            raise ValueError(f"batch of {n} frames, batch_size is "
                             f"{self.batch_size}")
        batch = self.device_batch(rgbs, depths, intrinsics)
        completed, pred_z = self.forward(batch, seed)
        with profiling.span("infer.read_back"):  # the call's one read-back
            both = torch.stack([completed, pred_z]).cpu().numpy()
        completed, pred_z = both[0, :n], both[1, :n]
        out_depth = []
        for img, depth0 in zip(completed, depths):
            depth0 = np.asarray(depth0, np.float32)
            if depth0.shape != (self.h, self.w):
                img = cv.resize(img, depth0.shape[::-1], cv.INTER_NEAREST)
            # input depth where present, bit for bit against the input frame
            out_depth.append(np.where(depth0 == 0, img, depth0))
        same = len({d.shape for d in out_depth}) == 1
        return {"depth": np.stack(out_depth) if same else out_depth,
                "depth_pred": pred_z}
