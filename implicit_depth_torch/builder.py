"""Config -> model/static builders (counterpart of
``implicit_depth_tpu/builder.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from implicit_depth_torch.config import Config
from implicit_depth_torch.geometry.voxel import make_voxel_grid
from implicit_depth_torch.models.imnet import IEF, IMNet
from implicit_depth_torch.models.lidf import LIDFModel, LIDFStatic
from implicit_depth_torch.models.refine import RefineModel
from implicit_depth_torch.models.resnet import ResNet34_8s

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_static(cfg: Config, n_rays: Optional[int] = None,
                 n_valid: Optional[int] = None) -> LIDFStatic:
    grid = make_voxel_grid(cfg.grid.res)
    nv = n_valid if n_valid is not None else cfg.grid.valid_sample_num
    use_all_valid = nv == -1  # every valid pixel is a point
    if use_all_valid:
        nv = cfg.dataset.img_height * cfg.dataset.img_width
    return LIDFStatic(
        grid=grid,
        n_valid=nv,
        n_rays=n_rays or cfg.grid.miss_sample_num,
        k_pairs=cfg.tpu.max_pairs_per_ray,
        roi_inp_bbox=cfg.model.roi_inp_bbox,
        roi_out_bbox=cfg.model.roi_out_bbox,
        use_all_valid=use_all_valid,
    )


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.tpu.compute_dtype]


def build_lidf(cfg: Config, static: LIDFStatic,
               generator: Optional[torch.Generator] = None) -> LIDFModel:
    """Stage-1 model with random weights drawn from ``generator``."""
    m = cfg.model
    return LIDFModel(
        static,
        rgb_out=m.rgb_out,
        pnet_out=m.pnet_out,
        pnet_gf=m.pnet_gf,
        imnet_gf=m.imnet_gf,
        multires=m.multires,
        multires_views=m.multires_views,
        pos_encode=m.pos_encode,
        intersect_pos_type=m.intersect_pos_type,
        offdec_type=m.offdec_type,
        n_iter=m.n_iter,
        use_sigmoid=m.use_sigmoid,
        offset_range=tuple(cfg.grid.offset_range),
        resnet_stages=tuple(m.get("resnet_stages", (3, 4, 6, 3))),
        pairs_budget=cfg.tpu.get("pairs_budget_per_ray", 0),
        pairs_budget_mode=cfg.tpu.get("pairs_budget_mode", "per_ray"),
        decode_bwd=cfg.tpu.get("decode_bwd", "kernel_save"),
        dtype=compute_dtype(cfg),
        generator=generator,
    )


def build_refine(cfg: Config, static: LIDFStatic,
                 generator: Optional[torch.Generator] = None) -> RefineModel:
    """Stage-2 model with random weights drawn from ``generator``."""
    r = cfg.refine
    return RefineModel(
        static,
        rgb_out=cfg.model.rgb_out,
        pnet_out=r.pnet_out,
        pnet_gf=r.pnet_gf,
        imnet_gf=r.imnet_gf,
        multires=r.multires,
        multires_views=r.multires_views,
        pos_encode=r.pos_encode,
        intersect_pos_type=r.intersect_pos_type,
        pnet_pos_type=r.pnet_pos_type,
        offdec_type=r.offdec_type,
        n_iter=r.n_iter,
        use_sigmoid=r.use_sigmoid,
        offset_range=tuple(r.offset_range),
        dtype=compute_dtype(cfg),
        generator=generator,
    )


@torch.no_grad()
def randomize_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraws every weight of ``model`` in place at unit activation scale,
    for numerical checks with random weights; returns ``model``.

    The builders follow the flax initialisers, whose decoder kernels
    (N(0, 0.02), last layer at mean 1e-5) make every decoder output ~1e-3:
    too small for a comparison to tell a right decode from a wrong one.
    Here Dense and Conv kernels are lecun-normal, biases N(0, 0.1), and
    BatchNorm scale 1 + N(0, 0.1), shift and mean N(0, 0.1), var 0.5 +
    0.5·|N(0, 1)|. Two layers then get a quarter of that kernel scale, so
    that the decoders' raw outputs stay inside (0, 1), where the soft clamp
    passes them unchanged instead of compressing them 100×: the ResNet's
    1×1 head, whose input has grown ~4× through the residual blocks, and
    each decoder's last layer, whose bias is set so that the raw output sits
    near 0.5 after all its iterations."""
    def normal(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=generator) * std + mean)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            normal(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                normal(mod.bias, 0.1)
        elif isinstance(mod, nn.BatchNorm2d):
            normal(mod.weight, 0.1, 1.0)
            normal(mod.bias, 0.1)
            normal(mod.running_mean, 0.1)
            mod.running_var.copy_(
                0.5 + 0.5 * torch.randn(mod.running_var.shape,
                                        generator=generator).abs())
    for mod in model.modules():
        if isinstance(mod, ResNet34_8s):
            mod.fc.weight.mul_(0.25)
        elif isinstance(mod, (IEF, IMNet)):
            last = mod.mlp.l3
            last.weight.mul_(0.25)
            last.bias.fill_(0.5 / mod.n_iter if isinstance(mod, IEF) else 0.5)
    return model
