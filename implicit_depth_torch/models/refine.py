"""RefineNet stage 2: one refinement iteration, its training perturbation
and its loss (counterpart of ``implicit_depth_tpu/models/refine.py``).

Each iteration re-localizes every predicted point's ending voxel (the cell
it lands in when that cell is occupied, else the stage-1 argmax-pair voxel),
injects the predicted points into the PointNet input, re-embeds
[end voxel feature | ROI feature | posenc(prediction) | posenc(ray dir)] and
decodes a signed offset along the ray. Without autograd (serving, eval) the
decode is ``ops/ray_decode.ief_decode`` (kernel K4 on the card) on cached
operands; with grad enabled it is ``ief_decode_train`` on operands split
from the live parameters (K4 forward and the plain recompute backward on
the card), so the decoder and the PointNet get their gradients through it.
Training perturbs the stage-1 prediction once, before the first iteration
(:func:`perturb_pred_pos`, :func:`refine_forward`); :func:`refine_loss` is
the stage-2 loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from implicit_depth_torch.models.embedder import posenc_dim, positional_encoding
from implicit_depth_torch.models.imnet import IEF
from implicit_depth_torch.models.init import PreparedWeights
from implicit_depth_torch.models.lidf import (
    LIDFStatic,
    hard_neg_mean,
    masked_mean,
    surf_smooth_terms,
)
from implicit_depth_torch.models.pointnet import PointNet2Stage
from implicit_depth_torch.ops.masked import take_slot
from implicit_depth_torch.ops.ray_decode import (
    ief_decode,
    ief_decode_train,
    prep_ief_weights,
    split_ief_weights,
)

Tensors = Dict[str, torch.Tensor]


def perturb_pred_pos(pred_pos: torch.Tensor, miss_dir: torch.Tensor,
                     perturb_prob: float = 0.8, *,
                     generator: Optional[torch.Generator] = None,
                     apply: Optional[torch.Tensor] = None,
                     bucket: Optional[torch.Tensor] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's noise mixture, one scalar per image, along the ray:
    with probability ``perturb_prob`` a shift drawn from [-0.05, 0) (half
    the images), [0, 0.05) (3/10), [-0.1, -0.05) or [0.05, 0.1) (1/10 each)
    meters. ``apply``, ``bucket``, ``u``: the three (B,) uniform draws in
    [0, 1), in that order; each not given is drawn from ``generator``."""
    b = pred_pos.shape[0]
    dev = pred_pos.device

    def draw(given):
        if given is not None:
            return given.to(device=dev, dtype=torch.float32)
        return torch.rand((b,), generator=generator, device=dev)

    apply, bucket, u = draw(apply), draw(bucket), draw(u)
    noise = torch.where(
        bucket < 0.5, u * 0.05 - 0.05,
        torch.where(bucket < 0.8, u * 0.05,
                    torch.where(bucket < 0.9, -0.1 + u * 0.05,
                                0.05 + u * 0.05)))
    noise = torch.where(apply < perturb_prob, noise, torch.zeros_like(noise))
    return pred_pos + noise[:, None, None] * miss_dir


class RefineModel(nn.Module):
    def __init__(self, static: LIDFStatic, rgb_out: int = 32,
                 pnet_out: int = 128, pnet_gf: int = 32, imnet_gf: int = 64,
                 multires: int = 8, multires_views: int = 4,
                 pos_encode: bool = True, intersect_pos_type: str = "abs",
                 pnet_pos_type: str = "rel", offdec_type: str = "IEF",
                 n_iter: int = 2, use_sigmoid: bool = False,
                 offset_range: Sequence[float] = (-0.2, 0.2),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not (pos_encode and offdec_type == "IEF"):
            raise NotImplementedError("only the IEF offset decoder with "
                                      "positional encoding is ported")
        self.static = static
        self.multires, self.multires_views = multires, multires_views
        self.intersect_pos_type = intersect_pos_type
        self.pnet_pos_type = pnet_pos_type
        self.n_iter, self.use_sigmoid = n_iter, use_sigmoid
        self.offset_range = tuple(offset_range)
        self.dtype = dtype
        roi_dim = rgb_out * static.roi_out_bbox ** 2
        c_dir = posenc_dim(multires_views)
        self.dims = {"c_end": pnet_out, "c_rc": roi_dim + c_dir,
                     "c_pos": posenc_dim(multires), "c_dir": c_dir}
        self.pnet = PointNet2Stage(out_channels=pnet_out, gf_dim=pnet_gf,
                                   generator=generator)
        self.offset_dec = IEF(pnet_out + roi_dim + posenc_dim(multires) + c_dir,
                              gf_dim=imnet_gf, n_iter=n_iter,
                              use_sigmoid=use_sigmoid, generator=generator)
        self._decode_w = PreparedWeights()

    def decode_operands(self) -> Tensors:
        """K4's weight operands in the compute dtype, prepared once and
        reused while the decoder parameters and the dtype stay unchanged
        (serving and eval; detached)."""
        return self._decode_w.get(
            (self.offset_dec,), self.dtype,
            lambda: prep_ief_weights(
                self.offset_dec.decode_weights(), self.dims["c_end"],
                self.dims["c_rc"], self.dims["c_pos"], self.dims["c_dir"],
                self.dtype))

    def train_operands(self) -> Tensors:
        """The f32 split decode operands of the training decode, from the
        live parameters on every call (no cache: gradients flow back through
        the split)."""
        return split_ief_weights(
            self.offset_dec.decode_weights(detach=False), self.dims["c_end"],
            self.dims["c_rc"], self.dims["c_pos"], self.dims["c_dir"],
            self.dtype)

    def forward(self, inputs: Tensors, lidf_out: Tensors,
                pred_pos: torch.Tensor,
                inject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pred_pos (B, R, 3) -> refined (B, R, 3). ``inject_mask`` (B, R)
        optionally restricts which predictions enter the PointNet input."""
        grid = self.static.grid
        b, r, _ = pred_pos.shape
        n = inputs["valid_xyz"].shape[1]
        dev = pred_pos.device

        # -- end-voxel re-localization ------------------------------------
        ijk = grid.cell_of(pred_pos)
        inb = grid.in_bounds(ijk)
        cand = torch.where(inb, grid.linear_id(ijk), torch.zeros_like(ijk[..., 0]))
        contained = inb & inputs["occupancy"].gather(1, cand.long())
        fallback = take_slot(inputs["pair_cell"], lidf_out["max_slot"])
        end_cell = torch.where(contained, cand, fallback)
        end_center = grid.cell_center(grid.unlinear(end_cell), pred_pos.dtype)

        # -- PointNet with the predictions injected -----------------------
        miss_rgb = inputs["miss_rgb"]
        if self.pnet_pos_type == "rel":
            pred_inp = torch.cat([pred_pos - end_center, miss_rgb], -1)
            valid_inp = torch.cat([inputs["vox_rel_coord"], inputs["valid_rgb"]], -1)
        else:
            pred_inp = torch.cat([pred_pos, miss_rgb], -1)
            valid_inp = torch.cat([inputs["valid_xyz"], inputs["valid_rgb"]], -1)
        base = torch.arange(b, dtype=torch.int32, device=dev)[:, None] * grid.n_cells
        seg_valid = base + inputs["vox_cell_id"]
        seg_pred = base + end_cell
        pred_ok = inputs["miss_slot"] & lidf_out["has_pair"]
        if inject_mask is not None:
            pred_ok = pred_ok & inject_mask
        vox_feat = self.pnet.call_split(
            [(valid_inp.reshape(b * n, -1), seg_valid.reshape(-1),
              inputs["vox_point_valid"].reshape(-1)),
             (pred_inp.reshape(b * r, -1), seg_pred.reshape(-1),
              pred_ok.reshape(-1))], b * grid.n_cells, self.dtype)
        end_feat = vox_feat[seg_pred.reshape(-1).long()]          # (B·R, 128)

        # -- embedding parts + IEF decode ---------------------------------
        pos_inp = (pred_pos - end_center if self.intersect_pos_type == "rel"
                   else pred_pos)
        pos_e = positional_encoding(pos_inp, self.multires)
        dir_e = positional_encoding(inputs["miss_dir"], self.multires_views)
        rc = torch.cat([lidf_out["roi_feat"].to(self.dtype),
                        dir_e.to(self.dtype)], -1)
        rows = (end_feat.to(self.dtype), rc.reshape(b * r, -1),
                pos_e.reshape(b * r, -1).to(self.dtype))
        kw = dict(n_iter=self.n_iter, init_offset=self.offset_dec.init_offset,
                  use_sigmoid=self.use_sigmoid)
        if torch.is_grad_enabled():
            off = ief_decode_train(*rows, self.train_operands(), self.dtype,
                                   **kw)
        else:
            off = ief_decode(*rows, self.decode_operands(), **kw)
        off = off.reshape(b, r)
        lo, hi = self.offset_range
        scaled = off * (hi - lo) + lo
        return pred_pos + scaled[..., None] * inputs["miss_dir"]


def refine_forward(model: RefineModel, inputs: Tensors, lidf_out: Tensors,
                   forward_times: int, *, perturb: bool = False,
                   perturb_prob: float = 0.8,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Tensors] = None,
                   inject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``forward_times`` iterations from the stage-1 prediction; with
    ``perturb`` (training) the prediction is perturbed before the first one
    only (the draws from ``generator``, or ``noise``: {apply, bucket, u})."""
    pred = lidf_out["pred_pos"]
    for it in range(forward_times):
        if perturb and it == 0:
            pred = perturb_pred_pos(pred, inputs["miss_dir"], perturb_prob,
                                    generator=generator, **(noise or {}))
        pred = model(inputs, lidf_out, pred, inject_mask)
    return pred


def refine_loss(inputs: Tensors, pred_pos_refine: torch.Tensor, *,
                train: bool, img_hw, pos_w: float = 100.0,
                surf_norm_w: float = 10.0, smooth_w: float = 0.0,
                surf_norm_on=True, smooth_on=True, hard_neg: bool = False,
                hard_neg_ratio: float = 0.1) -> Tensors:
    """The stage-2 loss: position L1 and the surface-normal (and smoothness)
    terms, no termination term; ``err`` over the rays with a non-zero
    ground truth. The gates follow ``lidf_loss``."""
    slot = inputs["miss_slot"]
    gt_pos = inputs["gt_pos"]
    reduce = ((lambda v, m: hard_neg_mean(v, m, hard_neg_ratio))
              if hard_neg else masked_mean)
    pos_loss = reduce((pred_pos_refine - gt_pos).abs().mean(-1), slot)
    surf_norm_loss, angle_err, smooth_loss = surf_smooth_terms(
        inputs, pred_pos_refine, train=train, img_hw=img_hw,
        hard_neg=hard_neg, hard_neg_ratio=hard_neg_ratio,
        want_smooth=bool(smooth_w) or smooth_on is True)

    def flag(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=pred_pos_refine.device)

    loss_net = (pos_w * pos_loss
                + surf_norm_w * flag(surf_norm_on) * surf_norm_loss
                + smooth_w * flag(smooth_on) * smooth_loss)
    nz = (gt_pos.abs().sum(-1) != 0) & slot
    err = masked_mean(((pred_pos_refine - gt_pos) ** 2).sum(-1).sqrt(), nz)
    return {"pos_loss": pos_loss, "surf_norm_loss": surf_norm_loss,
            "smooth_loss": smooth_loss, "loss_net": loss_net, "err": err,
            "angle_err": angle_err}
