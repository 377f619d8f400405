"""RefineNet stage 2: one refinement iteration (counterpart of
``implicit_depth_tpu/models/refine.py::RefineModel``).

Each iteration re-localizes every predicted point's ending voxel (the cell
it lands in when that cell is occupied, else the stage-1 argmax-pair voxel),
injects the predicted points into the PointNet input, re-embeds
[end voxel feature | ROI feature | posenc(prediction) | posenc(ray dir)] and
decodes a signed offset along the ray through
``ops/ray_decode.ief_decode`` (kernel K4 on the card). The training-only
parts (``perturb_pred_pos``, ``refine_loss``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from implicit_depth_torch.models.embedder import posenc_dim, positional_encoding
from implicit_depth_torch.models.imnet import IEF
from implicit_depth_torch.models.init import PreparedWeights
from implicit_depth_torch.models.lidf import LIDFStatic
from implicit_depth_torch.models.pointnet import PointNet2Stage
from implicit_depth_torch.ops.masked import take_slot
from implicit_depth_torch.ops.ray_decode import ief_decode, prep_ief_weights

Tensors = Dict[str, torch.Tensor]


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
        reused while the decoder parameters and the dtype stay unchanged."""
        return self._decode_w.get(
            (self.offset_dec,), self.dtype,
            lambda: prep_ief_weights(
                self.offset_dec.decode_weights(), self.dims["c_end"],
                self.dims["c_rc"], self.dims["c_pos"], self.dims["c_dir"],
                self.dtype))

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
        off = ief_decode(end_feat.to(self.dtype), rc.reshape(b * r, -1),
                         pos_e.reshape(b * r, -1).to(self.dtype),
                         self.decode_operands(),
                         n_iter=self.n_iter,
                         init_offset=self.offset_dec.init_offset,
                         use_sigmoid=self.use_sigmoid).reshape(b, r)
        lo, hi = self.offset_range
        scaled = off * (hi - lo) + lo
        return pred_pos + scaled[..., None] * inputs["miss_dir"]
