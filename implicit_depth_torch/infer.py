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
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from implicit_depth_torch.config import Config, load_config
from implicit_depth_torch.data.augmentation import standardize_image
from implicit_depth_torch.geometry.camera import compute_xyz
from implicit_depth_torch.models.lidf import LIDFModel, prepare_inputs
from implicit_depth_torch.models.refine import RefineModel, refine_forward

Intrinsics = Union[Tuple[float, float, float, float], Sequence[float]]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device without a card
    (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device "
                           "is available")
    return dev


def _resize(img: np.ndarray, h: int, w: int, mode: str) -> np.ndarray:
    """(H0, W0[, C]) -> (h, w[, C]) float32 on the host; ``bilinear`` with
    half-pixel centers (align_corners=False) or ``nearest``."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    kw = {"align_corners": False} if mode == "bilinear" else {}
    out = F.interpolate(t, size=(h, w), mode=mode, **kw)[0]
    return (out[0] if img.ndim == 2 else out.permute(1, 2, 0)).numpy()


class DepthCompleter:
    """Two-stage (LIDF + optional RefineNet) depth completion as a service.

    ``lidf`` / ``refine`` are the port's modules with their weights (random
    from ``builder``, loaded with ``weights.lidf_from_jax``, or trained:
    :meth:`from_checkpoint`). The models
    are moved to ``device`` and put in eval mode. ``batch_size`` is the most
    frames one :meth:`complete_batch` call takes."""

    def __init__(self, cfg: Optional[Config] = None, *, lidf: LIDFModel,
                 refine: Optional[RefineModel] = None, batch_size: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
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

    @classmethod
    def from_checkpoint(cls, lidf_ckpt_dir: str,
                        refine_ckpt_dir: Optional[str] = None,
                        cfg: Optional[Config] = None,
                        ckpt_name: str = "best_network", batch_size: int = 1,
                        device: Union[str, torch.device] = "cuda"
                        ) -> "DepthCompleter":
        """Serve trained weights from the checkpoint directories of the
        trainers (``train/checkpoint.py``): the stage-1 model and, when
        ``refine_ckpt_dir`` is given, the stage-2 model, each built from
        ``cfg`` and loaded by ``restore_params_only``. ``ckpt_name`` falls
        back to ``latest_network`` where a directory has no such
        checkpoint."""
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
                   device=device)

    # -- device forward -----------------------------------------------------
    @torch.inference_mode()
    def forward(self, batch: Dict[str, torch.Tensor], seed: int = 0,
                valid_idx: Optional[torch.Tensor] = None):
        """Two-stage forward of a device batch dict -> (completed (B, h, w),
        pred_z (B, h, w)), both on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        inputs = prepare_inputs(self.static, batch, train=False,
                                mask_type="all", generator=gen,
                                valid_idx=valid_idx)
        out = self.lidf(inputs)
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

    # -- host-side frame handling ------------------------------------------
    def _prep_frame(self, rgb: np.ndarray, depth: np.ndarray,
                    intr: Intrinsics):
        """Resize a frame to the model resolution -> (rgb (h, w, 3)
        standardized, depth (h, w), (fx, fy, cx, cy)), float32."""
        fx, fy, cx, cy = (float(v) for v in intr)
        h0, w0 = depth.shape[:2]
        is_u8 = rgb.dtype == np.uint8
        if (h0, w0) != (self.h, self.w):
            rgb = _resize(rgb, self.h, self.w, "bilinear")
            depth = _resize(depth, self.h, self.w, "nearest")
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

    def device_batch(self, rgbs, depths, intrinsics) -> Dict[str, torch.Tensor]:
        """Host frames -> the device batch dict of :meth:`forward`, padded to
        ``batch_size`` by repeating the last frame."""
        frames = [self._prep_frame(np.asarray(r), np.asarray(d), i)
                  for r, d, i in zip(rgbs, depths, intrinsics)]
        frames += [frames[-1]] * (self.batch_size - len(frames))
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

    def complete_batch(self, rgbs, depths, intrinsics,
                       seed: int = 0) -> Dict[str, np.ndarray]:
        """Batched :meth:`complete` of at most ``batch_size`` frames."""
        n = len(rgbs)
        if not (0 < n <= self.batch_size):
            raise ValueError(f"batch of {n} frames, batch_size is "
                             f"{self.batch_size}")
        batch = self.device_batch(rgbs, depths, intrinsics)
        completed, pred_z = self.forward(batch, seed)
        both = torch.stack([completed, pred_z]).cpu().numpy()  # one readback
        completed, pred_z = both[0, :n], both[1, :n]
        out_depth = []
        for img, depth0 in zip(completed, depths):
            depth0 = np.asarray(depth0, np.float32)
            if depth0.shape != (self.h, self.w):
                img = _resize(img, *depth0.shape, "nearest")
            # input depth where present, bit for bit against the input frame
            out_depth.append(np.where(depth0 == 0, img, depth0))
        same = len({d.shape for d in out_depth}) == 1
        return {"depth": np.stack(out_depth) if same else out_depth,
                "depth_pred": pred_z}
