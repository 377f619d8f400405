"""LIDF stage 1: local implicit depth function (counterpart of
``implicit_depth_tpu/models/lidf.py``).

* :func:`prepare_inputs` — the geometry stage: valid-point sampling, the
  dense 9³ occupancy grid, the ray/grid pair slots and the labels; for
  training (``train=True``) the miss rays are a random window of each
  image's corrupted pixels.
* :class:`LIDFModel` — ResNet34-8s features, two-stage PointNet voxel
  features, per-ray ROI features and the pair decode, then the masked
  softmax/argmax over the slots and the predicted position. Three decode
  modes, chosen as the JAX package chooses them:
  - ``per_ray`` (0 < pairs_budget < K, the default): the ray-major decode of
    each ray's ``pairs_budget`` nearest slots. In eval mode
    ``ops/ray_decode.ray_decode`` (kernel K1 on the card); in train mode
    (``.train()``) ``ray_decode_train`` (K2 or K1 forward, K3 backward) on
    operands prepared from the live parameters.
  - ``global`` (``pairs_budget_mode='global'``): the valid pairs of the
    whole batch compacted to B·R·pairs_budget rows, the farthest dropped
    first, decoded by ``ops/pair_decode.pair_decode`` (K6 on the card) and
    scattered back to (B, R, K); dropped pairs leave the per-ray
    competitions.
  - dense (pairs_budget 0, or >= K): every (B, R, K) slot through K6.
  K6 has no backward (nor has the JAX kernel): in train mode the ``global``
  and dense decodes run the plain version under autograd on the CPU, as the
  JAX package trains them with ``use_pallas_decode: false``, and raise on
  the card.
* :func:`lidf_loss` — position L1, per-ray termination cross-entropy,
  surface-normal and smoothness terms, and the metrics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from implicit_depth_torch.geometry.normals import surface_normals_planar
from implicit_depth_torch.geometry.rays import ray_dir_map
from implicit_depth_torch.geometry.sampling import (
    sample_masked_window,
    sample_valid_stratified,
)
from implicit_depth_torch.geometry.voxel import VoxelGrid, voxelize_points
from implicit_depth_torch.models.embedder import posenc_dim, positional_encoding
from implicit_depth_torch.models.imnet import IEF, IMNet
from implicit_depth_torch.models.init import PreparedWeights
from implicit_depth_torch.models.pointnet import PointNet2Stage
from implicit_depth_torch.models.resnet import ResNet34_8s
from implicit_depth_torch.ops.masked import (
    masked_argmax,
    masked_log_softmax,
    masked_softmax,
    take_slot,
)
from implicit_depth_torch.ops.pair_decode import (
    pair_decode,
    pair_decode_plain,
    pair_decode_weights,
    prep_pair_decode_weights,
    round_pair_biases,
)
from implicit_depth_torch.ops.ray_decode import (
    prep_ray_decode_weights,
    ray_decode,
    ray_decode_train,
    split_ray_decode_weights,
)
from implicit_depth_torch.ops.ray_grid import ray_grid_intersect
from implicit_depth_torch.ops.roi_align import roi_window_pool

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LIDFStatic:
    """Static shape/geometry configuration shared by prepare/model."""

    grid: VoxelGrid
    n_valid: int = 10000       # grid.valid_sample_num (H*W when use_all_valid)
    n_rays: int = 20000        # grid.miss_sample_num (train); H*W at eval
    k_pairs: int = 20          # tpu.max_pairs_per_ray
    roi_inp_bbox: int = 8
    roi_out_bbox: int = 2
    use_all_valid: bool = False  # grid.valid_sample_num == -1


def prepare_inputs(static: LIDFStatic, batch: Tensors, train: bool = False,
                   mask_type: str = "all",
                   pred_mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   valid_idx: Optional[torch.Tensor] = None,
                   miss_start: Optional[torch.Tensor] = None) -> Tensors:
    """Geometry stage: sampling, voxelization, ray/grid pairs, GT labels.

    batch: rgb (B,H,W,3) standardized; xyz / xyz_corrupt (B,H,W,3);
    depth_corrupt (B,H,W); corrupt_mask / valid_mask (B,H,W) {0,1};
    fx, fy, cx, cy (B,). Eval and serving (``train=False``): every pixel is
    a ray slot, the masks follow ``mask_type``. Training: the miss rays are
    ``static.n_rays`` slots of a random window of the corrupted pixels and
    the valid points come from ``valid_mask``. The random draws come from
    ``generator``; ``valid_idx`` (B, n_valid) and ``miss_start`` (B,)
    replace them with given ones."""
    grid = static.grid
    rgb = batch["rgb"]
    b, h, w, _ = rgb.shape
    dev = rgb.device
    if train:
        miss_mask = batch["corrupt_mask"] > 0.5
        valid_mask = batch["valid_mask"] > 0.5
    elif mask_type == "pred":
        if pred_mask is None:
            raise ValueError("mask_type='pred' needs a pred_mask")
        miss_mask = pred_mask > 0.5
        valid_mask = ~miss_mask
    elif mask_type == "all":  # every zero-input-depth pixel is a ray
        miss_mask = torch.ones((b, h, w), dtype=torch.bool, device=dev)
        valid_mask = batch["depth_corrupt"] != 0
    else:
        raise ValueError(f"mask_type {mask_type!r}")

    # -- valid points -----------------------------------------------------
    if static.use_all_valid:
        vidx = torch.arange(h * w, dtype=torch.int32,
                            device=dev).expand(b, h * w)
        vslot = valid_mask.reshape(b, -1)
    elif valid_idx is not None:
        vidx = valid_idx.to(device=dev, dtype=torch.int32)
        vslot = valid_mask.reshape(b, -1).any(1)[:, None].expand(vidx.shape)
    else:
        vidx, vslot, _ = sample_valid_stratified(valid_mask, static.n_valid,
                                                 generator)
    xyz_corrupt_flat = batch["xyz_corrupt"].reshape(b, h * w, 3)
    vg = torch.cat([xyz_corrupt_flat, rgb.reshape(b, h * w, 3)], -1).gather(
        1, vidx.long()[..., None].expand(-1, -1, 6))
    valid_xyz, valid_rgb = vg[..., :3], vg[..., 3:]

    # -- occupied voxels ----------------------------------------------------
    vox = voxelize_points(grid, valid_xyz, vslot)

    # -- rays: a window of the miss pixels (train), else every pixel -------
    dirs = ray_dir_map(h, w, batch["fx"], batch["fy"], batch["cx"],
                       batch["cy"], device=dev)
    xyz_flat = batch["xyz"].reshape(b, h * w, 3)
    out = {}
    if train:
        miss_mask_flat = miss_mask.reshape(b, -1)
        # cumsum rank computed once; the loss-image writes reuse it
        miss_rank = torch.cumsum(miss_mask_flat.int(), 1, dtype=torch.int32) - 1
        midx, mslot, _, mstart = sample_masked_window(
            miss_mask_flat, static.n_rays, generator, rank=miss_rank,
            start=miss_start)
        mg = torch.cat([dirs.reshape(b, h * w, 3), xyz_flat,
                        rgb.reshape(b, h * w, 3)], -1).gather(
            1, midx.long()[..., None].expand(-1, -1, 9))
        miss_dir, gt_pos, miss_rgb = mg[..., :3], mg[..., 3:6], mg[..., 6:]
        out["miss_rank"] = miss_rank
    else:  # eval rays are pixel-aligned (miss_idx == arange)
        midx = torch.arange(h * w, dtype=torch.int32,
                            device=dev).expand(b, h * w)
        mslot = miss_mask.reshape(b, -1)
        miss_mask_flat = mslot
        mstart = torch.zeros((b,), dtype=torch.int32, device=dev)
        miss_dir = dirs.reshape(b, h * w, 3)
        gt_pos = xyz_flat
        miss_rgb = rgb.reshape(b, h * w, 3)

    pairs = ray_grid_intersect(grid, miss_dir, vox["occupancy"],
                               static.k_pairs, ray_mask=mslot)

    # -- labels: point-in-voxel is a floor ----------------------------------
    gt_ijk = grid.cell_of(gt_pos)
    gt_cell = torch.where(grid.in_bounds(gt_ijk), grid.linear_id(gt_ijk),
                          torch.full_like(gt_ijk[..., 0], -1))
    pair_label = pairs["valid"] & (pairs["cell_id"] == gt_cell[..., None])

    out.update({
        "rgb": rgb,
        "xyz_flat": xyz_flat,
        "xyz_corrupt_flat": xyz_corrupt_flat,
        "corrupt_mask": batch["corrupt_mask"],
        "valid_xyz": valid_xyz,
        "valid_rgb": valid_rgb,
        "valid_slot": vslot,
        "valid_idx": vidx,
        "vox_cell_id": vox["cell_id"],
        "vox_point_valid": vox["valid"],
        "vox_rel_coord": vox["rel_coord"],
        "occupancy": vox["occupancy"],
        "miss_idx": midx,
        "miss_slot": mslot,
        "miss_mask_flat": miss_mask_flat,
        "miss_start": mstart,
        "miss_dir": miss_dir,
        "miss_rgb": miss_rgb,
        "miss_px": midx % w,
        "miss_py": torch.div(midx, w, rounding_mode="floor"),
        "pair_cell": pairs["cell_id"],
        "pair_valid": pairs["valid"],
        "t_enter": pairs["t_enter"],
        "t_exit": pairs["t_exit"],
        "gt_pos": gt_pos,
        "pair_label": pair_label,
    })
    return out


def decoder_weights(offset_dec: IEF, prob_dec: IMNet) -> Tensors:
    """The IEF offset + IMNet prob decoder parameters in the JAX package's
    decode weight-dict layout (kernels (in, out)), as views of the live
    parameters."""
    w = {"off_enc_w": offset_dec.offset_enc.weight.t(),
         "off_enc_b": offset_dec.offset_enc.bias}
    for i, (lo, lp) in enumerate(zip(offset_dec.mlp.layers(),
                                     prob_dec.mlp.layers()), 1):
        w[f"off_w{i}"], w[f"off_b{i}"] = lo.weight.t(), lo.bias
        w[f"prob_w{i}"], w[f"prob_b{i}"] = lp.weight.t(), lp.bias
    return w


class LIDFModel(nn.Module):
    """Parameterized stage-1 compute (get_embedding + get_pred)."""

    def __init__(self, static: LIDFStatic, rgb_out: int = 32,
                 pnet_out: int = 128, pnet_gf: int = 32, imnet_gf: int = 64,
                 multires: int = 8, multires_views: int = 4,
                 pos_encode: bool = True, intersect_pos_type: str = "abs",
                 offdec_type: str = "IEF", n_iter: int = 2,
                 use_sigmoid: bool = False,
                 offset_range: Sequence[float] = (0.0, 1.0),
                 resnet_stages: Sequence[int] = (3, 4, 6, 3),
                 pairs_budget: int = 8, pairs_budget_mode: str = "per_ray",
                 decode_bwd: str = "kernel_save",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not (pos_encode and offdec_type == "IEF"):
            raise NotImplementedError("only the IEF offset decoder with "
                                      "positional encoding is ported")
        if pairs_budget > 0 and pairs_budget_mode == "per_ray" \
                and pairs_budget < static.k_pairs:
            self.decode_mode = "per_ray"
        elif pairs_budget > 0 and pairs_budget_mode == "global":
            self.decode_mode = "global"
        else:
            self.decode_mode = "dense"
        self.static = static
        self.multires, self.multires_views = multires, multires_views
        self.intersect_pos_type = intersect_pos_type
        self.n_iter, self.use_sigmoid = n_iter, use_sigmoid
        self.offset_range = tuple(offset_range)
        self.pairs_budget = pairs_budget
        self.decode_bwd = decode_bwd
        self.dtype = dtype
        roi_dim = rgb_out * static.roi_out_bbox ** 2
        self.dims = {"c_vox": pnet_out, "c_roi": roi_dim,
                     "c_dir": posenc_dim(multires_views)}
        embed = pnet_out + roi_dim + 2 * posenc_dim(multires) \
            + posenc_dim(multires_views)
        self.resnet = ResNet34_8s(out_ch=rgb_out, stage_sizes=resnet_stages,
                                  generator=generator)
        self.pnet = PointNet2Stage(out_channels=pnet_out, gf_dim=pnet_gf,
                                   generator=generator)
        self.offset_dec = IEF(embed, gf_dim=imnet_gf, n_iter=n_iter,
                              use_sigmoid=use_sigmoid, generator=generator)
        self.prob_dec = IMNet(embed, gf_dim=imnet_gf, use_sigmoid=use_sigmoid,
                              generator=generator)
        self._decode_w = PreparedWeights()
        self._pair_w = PreparedWeights()

    def decode_operands(self) -> Tensors:
        """K1's weight operands in the compute dtype, prepared once and
        reused while the decoder parameters and the dtype stay unchanged
        (serving and eval; detached)."""
        return self._decode_w.get(
            (self.offset_dec, self.prob_dec), self.dtype,
            lambda: prep_ray_decode_weights(
                {k: v.detach() for k, v in
                 decoder_weights(self.offset_dec, self.prob_dec).items()},
                self.dims["c_vox"], self.dims["c_roi"], self.dims["c_dir"],
                self.multires, self.dtype))

    def train_operands(self) -> Tensors:
        """The f32 split decode operands of the training decode, from the
        live parameters on every call (no cache: gradients flow back through
        the split)."""
        return split_ray_decode_weights(
            decoder_weights(self.offset_dec, self.prob_dec),
            self.dims["c_vox"], self.dims["c_roi"], self.dims["c_dir"],
            self.multires, self.dtype)

    def pair_operands(self) -> Tensors:
        """K6's weight operands in the compute dtype, cached as
        :meth:`decode_operands` is."""
        return self._pair_w.get(
            (self.offset_dec, self.prob_dec), self.dtype,
            lambda: prep_pair_decode_weights(
                {k: v.detach() for k, v in
                 decoder_weights(self.offset_dec, self.prob_dec).items()},
                self.dims["c_vox"], self.dims["c_roi"], self.dims["c_dir"],
                self.multires, self.dtype))

    def voxel_features(self, inputs: Tensors) -> torch.Tensor:
        """(B·G³, pnet_out) f32 voxel features of the sampled valid points."""
        grid = self.static.grid
        b, n = inputs["valid_xyz"].shape[:2]
        pnet_inp = torch.cat([inputs["vox_rel_coord"], inputs["valid_rgb"]], -1)
        seg = (torch.arange(b, dtype=torch.int32, device=pnet_inp.device)[:, None]
               * grid.n_cells + inputs["vox_cell_id"])
        return self.pnet(pnet_inp.reshape(b * n, -1), seg.reshape(-1),
                         b * grid.n_cells,
                         inputs["vox_point_valid"].reshape(-1), self.dtype)

    def trunk(self, inputs: Tensors):
        """Per-image work shared by all rays: RGB features + voxel features."""
        return self.resnet(inputs["rgb"], self.dtype), self.voxel_features(inputs)

    def _pair_positions(self, inputs: Tensors):
        grid = self.static.grid
        dirs = inputs["miss_dir"][:, :, None, :]
        enter = dirs * inputs["t_enter"][..., None]
        leave = dirs * inputs["t_exit"][..., None]
        if self.intersect_pos_type == "rel":
            center = grid.cell_center(grid.unlinear(inputs["pair_cell"]))
            enter, leave = enter - center, leave - center
        return enter, leave

    def _decode_pairs(self, vox_feat, cells, pos, ray_feat, rays=None,
                      n_rows=None):
        """K6's decode of pair rows (see ``ops/pair_decode.pair_decode``;
        rows at or past the device count ``n_rows`` are 0 and, in the
        kernel, not decoded): the kernel in eval mode; in train mode the
        plain version under autograd at operands from the live parameters,
        on the CPU only."""
        kw = dict(n_rows=n_rows, n_iter=self.n_iter,
                  init_offset=self.offset_dec.init_offset,
                  use_sigmoid=self.use_sigmoid)
        if not self.training:
            return pair_decode(vox_feat.to(self.dtype), cells, pos, ray_feat,
                               self.pair_operands(), rays, **kw)
        if cells.device.type != "cpu":
            raise NotImplementedError(
                f"training in the {self.decode_mode!r} decode mode has no "
                "CUDA path: K6 (fused_pair_decode) has no backward in the JAX "
                "package, which trains this mode only through its plain XLA "
                "decode (use_pallas_decode: false); train on the CPU or in "
                "the per_ray mode")
        w = round_pair_biases(pair_decode_weights(
            decoder_weights(self.offset_dec, self.prob_dec),
            self.dims["c_vox"], self.dims["c_roi"], self.dims["c_dir"],
            self.multires, self.dtype), self.dtype)
        return pair_decode_plain(vox_feat, cells, pos, ray_feat, w, rays,
                                 dtype=self.dtype, **kw)

    def _decode_dense(self, inputs, vox_feat, ray_feat):
        """Every (B, R, K) slot, invalid ones included (cell 0, t 0: decoded
        and masked afterwards) -> (offset, logit), each (B, R, K)."""
        b, r, k = inputs["pair_valid"].shape
        cells = (torch.arange(b, dtype=torch.int32, device=vox_feat.device
                              )[:, None, None] * self.static.grid.n_cells
                 + inputs["pair_cell"])
        enter, leave = self._pair_positions(inputs)
        pos = torch.cat([enter, leave], -1).float().reshape(-1, 6)
        off, logit = self._decode_pairs(vox_feat, cells.reshape(-1), pos,
                                        ray_feat)
        return off.reshape(b, r, k), logit.reshape(b, r, k)

    def _decode_compacted(self, inputs, vox_feat, ray_feat):
        """The ``global`` mode (``_decode_compacted`` of the JAX package):
        the valid slots ranked k-major (every ray's nearest pair before any
        second-nearest), the first P = min(B·R·pairs_budget, B·R·K) taken,
        the results scattered back. The valid rows are the prefix of
        min(valid slots, P) rows, counted on the device: only those are
        decoded (the JAX package decodes the pad rows too, at slot 0, and
        zeroes them; the outputs are the same). Returns (offset, logit,
        decoded), each (B, R, K)."""
        b, r, k = inputs["pair_valid"].shape
        dev = vox_feat.device
        n_slots = b * r * k
        p = min(b * r * self.pairs_budget, n_slots)
        valid_km = inputs["pair_valid"].permute(2, 0, 1).reshape(-1)
        rank = torch.cumsum(valid_km.long(), 0) - 1
        rank = torch.where(valid_km & (rank < p), rank,
                           torch.full_like(rank, p))
        # slot p takes every dropped index and is cut off
        sel = torch.full((p + 1,), n_slots, dtype=torch.long,
                         device=dev).scatter_(
            0, rank, torch.arange(n_slots, device=dev))[:p]
        sel_valid = sel < n_slots
        sel = torch.where(sel_valid, sel, torch.zeros_like(sel))
        sel_ray = sel % (b * r)                      # flat b·R + r
        row = sel_ray * k + sel // (b * r)           # row-major (B, R, K)
        cells = (torch.div(sel_ray, r, rounding_mode="floor")
                 * self.static.grid.n_cells
                 + inputs["pair_cell"].reshape(-1)[row])
        enter, leave = self._pair_positions(inputs)
        pos = torch.cat([enter, leave], -1).float().reshape(-1, 6)[row]
        # the valid prefix's length, with no host sync
        n_rows = valid_km.sum().clamp(max=p).to(torch.int32)
        off_s, logit_s = self._decode_pairs(vox_feat, cells, pos, ray_feat,
                                            sel_ray, n_rows)
        row_w = torch.where(sel_valid, row, torch.full_like(row, n_slots))

        def scatter_back(v):
            v = torch.where(sel_valid, v, torch.zeros((), dtype=v.dtype,
                                                      device=dev))
            return torch.zeros((n_slots + 1,), dtype=v.dtype,
                               device=dev).scatter(0, row_w, v)[
                :n_slots].reshape(b, r, k)

        return (scatter_back(off_s), scatter_back(logit_s),
                scatter_back(sel_valid))

    def decode_rays(self, inputs: Tensors, feat_map: torch.Tensor,
                    vox_feat: torch.Tensor, use_gt_label=False) -> Tensors:
        """Per-ray work: ROI pooling, the pair decode of ``decode_mode``,
        per-ray softmax/argmax, predicted position. Outputs are (B, R, kb)
        in the ``per_ray`` mode, (B, R, K) in the others. In train mode the
        slot is the labelled one while ``use_gt_label`` (the
        ``maxpool_label_epo`` curriculum), else the most probable."""
        grid = self.static.grid
        b, r, _ = inputs["pair_valid"].shape
        kb = self.pairs_budget
        dev = feat_map.device

        pix_xy = torch.stack([inputs["miss_px"], inputs["miss_py"]], -1)
        bidx = torch.arange(b, device=dev)[:, None].expand(b, r)
        roi = roi_window_pool(feat_map, pix_xy, bidx,
                              inp_bbox=self.static.roi_inp_bbox,
                              out_bbox=self.static.roi_out_bbox).reshape(b, r, -1)
        dirs = inputs["miss_dir"]
        dir_e = positional_encoding(dirs, self.multires_views)
        ray_feat = torch.cat([roi.to(self.dtype), dir_e.to(self.dtype)],
                             -1).reshape(b * r, -1)

        if self.decode_mode == "per_ray":
            # the pair slots are t-sorted and front-packed: the first kb
            # slots are each ray's nearest pairs, a dense (B, R, kb) block
            sliced = {k: inputs[k][:, :, :kb] for k in
                      ("pair_cell", "pair_valid", "t_enter", "t_exit",
                       "pair_label")}
            sliced["miss_dir"] = dirs
            enter, leave = self._pair_positions(sliced)
            pos = torch.cat([enter, leave], -1).float().reshape(b * r, kb, 6)
            cells = (torch.arange(b, dtype=torch.int32,
                                  device=dev)[:, None, None]
                     * grid.n_cells + sliced["pair_cell"]).reshape(b * r, kb)
            kw = dict(n_iter=self.n_iter,
                      init_offset=self.offset_dec.init_offset,
                      use_sigmoid=self.use_sigmoid)
            if self.training:
                off, logit = ray_decode_train(vox_feat, cells, pos, ray_feat,
                                              self.train_operands(),
                                              self.dtype,
                                              decode_bwd=self.decode_bwd,
                                              **kw)
            else:
                off, logit = ray_decode(vox_feat.to(self.dtype), cells, pos,
                                        ray_feat, self.decode_operands(),
                                        **kw)
            pred_offset = off.reshape(b, r, kb)
            prob_logit = logit.reshape(b, r, kb)
            pair_valid = sliced["pair_valid"]
        else:
            sliced = inputs
            if self.decode_mode == "global":
                pred_offset, prob_logit, decoded = self._decode_compacted(
                    inputs, vox_feat, ray_feat)
                # pairs dropped by the budget have no logit: they leave
                # every per-ray competition
                pair_valid = inputs["pair_valid"] & decoded
            else:
                pred_offset, prob_logit = self._decode_dense(
                    inputs, vox_feat, ray_feat)
                pair_valid = inputs["pair_valid"]

        lo, hi = self.offset_range
        c_off = math.sqrt(3.0) * grid.part_size
        # the termination slot: softmax over detached logits; the labelled
        # slot during the curriculum (training only)
        prob_softmax = masked_softmax(prob_logit.detach(), pair_valid)
        max_slot, has_pair = masked_argmax(prob_softmax, pair_valid)
        if self.training and use_gt_label:
            max_slot, _ = masked_argmax(sliced["pair_label"].float(),
                                        pair_valid)
        t_sel = take_slot(sliced["t_enter"], max_slot)
        off_sel = take_slot(pred_offset, max_slot)
        scaled_sel = (off_sel * (hi - lo) + lo) * c_off
        pred_pos = dirs * (t_sel + scaled_sel)[..., None]
        pred_pos = torch.where(has_pair[..., None], pred_pos,
                               torch.zeros((), device=dev))
        return {
            "roi_feat": roi,
            "prob_logit": prob_logit,
            "prob_softmax": prob_softmax,
            "pair_valid": pair_valid,
            "pred_offset": pred_offset,
            "max_slot": max_slot,
            "has_pair": has_pair,
            "pred_pos": pred_pos,
        }

    def forward(self, inputs: Tensors, use_gt_label=False) -> Tensors:
        feat_map, vox_feat = self.trunk(inputs)
        out = self.decode_rays(inputs, feat_map, vox_feat, use_gt_label)
        return {**out, "feat_map": feat_map, "vox_feat": vox_feat}


# ---------------------------------------------------------------------------
# Loss (counterpart of the JAX package's lidf_loss and its helpers)
# ---------------------------------------------------------------------------

def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    num = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device)).sum()
    return num / mask.to(x.dtype).sum().clamp(min=1.0)


def hard_neg_mean(x: torch.Tensor, mask: torch.Tensor,
                  ratio: float) -> torch.Tensor:
    """Mean of the top-``ratio`` fraction of the masked values."""
    flat = torch.where(mask, x, torch.full((), float("-inf"), dtype=x.dtype,
                                           device=x.device)).reshape(-1)
    k = max(int(flat.shape[0] * ratio), 1)
    top = torch.topk(flat, k).values
    ok = torch.isfinite(top)
    return (torch.where(ok, top, torch.zeros_like(top)).sum()
            / ok.sum().clamp(min=1))


def window_in_mask(mask_flat, rank, start, r):
    """(B, M) bool: the mask pixels whose rank lies in the window
    [start, start + r), i.e. the pixels the r training ray slots cover."""
    j = rank - start[:, None]
    return mask_flat & (j >= 0) & (j < r)


def compose_pred_image(base_flat: torch.Tensor, values: torch.Tensor,
                       inputs: Tensors, train: bool) -> torch.Tensor:
    """``values`` (B, R, C) of the ray slots written into the (B, H·W, C)
    image ``base_flat`` at their pixels. Eval rays are pixel-aligned (a
    select); training rays are window slots, so pixel p takes slot
    rank(p) - start: one gather, whose gradient reaches each slot from its
    own pixel."""
    if not train:
        return torch.where(inputs["miss_slot"][..., None], values, base_flat)
    rank, start = inputs["miss_rank"], inputs["miss_start"]
    r = values.shape[1]
    in_win = window_in_mask(inputs["miss_mask_flat"], rank, start, r)
    j = (rank - start[:, None]).clamp(0, r - 1).long()
    vals = values.gather(1, j[..., None].expand(-1, -1, values.shape[-1]))
    return torch.where(in_win[..., None], vals, base_flat)


def surf_smooth_terms(inputs: Tensors, pred_pos: torch.Tensor, *, train: bool,
                      img_hw, hard_neg: bool, hard_neg_ratio: float,
                      want_smooth: bool):
    """(surf_norm_loss, angle_err, smooth_loss) over the miss pixels, from
    the channel-planar normals of the GT and the predicted point images;
    smooth_loss is 0 unless ``want_smooth``."""
    h, w = img_hw
    slot = inputs["miss_slot"]
    b = slot.shape[0]
    reduce = ((lambda v, m: hard_neg_mean(v, m, hard_neg_ratio))
              if hard_neg else masked_mean)
    base = inputs["xyz_flat"] if train else inputs["xyz_corrupt_flat"]
    # train: gt_pos is xyz_flat gathered at miss_idx, so writing it back
    # into xyz_flat is the identity
    gt_rows = base if train else compose_pred_image(
        base, inputs["gt_pos"], inputs, train)
    pr_rows = compose_pred_image(base, pred_pos, inputs, train)

    def planar(rows):
        return rows.reshape(b, h, w, 3).permute(0, 3, 1, 2)

    gt_n, _, _ = surface_normals_planar(planar(gt_rows))
    pr_n, dx, dy = surface_normals_planar(planar(pr_rows))
    cos_img = (gt_n * pr_n).sum(1).reshape(b, h * w)
    dist_img = (1.0 - cos_img) / 2.0
    if train:
        in_win = window_in_mask(inputs["miss_mask_flat"], inputs["miss_rank"],
                                inputs["miss_start"], slot.shape[1])
    else:
        in_win = slot
    angle = (masked_mean(torch.arccos(cos_img.clamp(-1, 1)), in_win)
             / math.pi * 180.0)
    zero = torch.zeros((), device=pred_pos.device)
    if want_smooth:
        dx2 = (dx * dx).sum(1).reshape(b, -1)
        dy2 = (dy * dy).sum(1).reshape(b, -1)
    if hard_neg:
        # hard negatives are chosen among the (B·R) ray slots
        def take1(im):
            return im.gather(1, inputs["miss_idx"].long())
        surf = reduce(take1(dist_img), slot)
        smooth = (reduce(take1(dx2), slot) + reduce(take1(dy2), slot)
                  if want_smooth else zero)
    else:
        surf = masked_mean(dist_img, in_win)
        smooth = (masked_mean(dx2, in_win) + masked_mean(dy2, in_win)
                  if want_smooth else zero)
    return surf, angle, smooth


def lidf_loss(inputs: Tensors, outputs: Tensors, *, train: bool, img_hw,
              pos_w: float = 100.0, prob_w: float = 0.5,
              surf_norm_w: float = 10.0, smooth_w: float = 0.0,
              surf_norm_on=True, smooth_on=True, hard_neg: bool = False,
              hard_neg_ratio: float = 0.1) -> Tensors:
    """Position L1, per-ray termination CE, surface-normal and smoothness
    terms (``loss_net``) and the metrics acc, err, angle_err. The smooth
    term is computed when ``smooth_w`` is set or ``smooth_on`` is the
    literal True; a tensor ``smooth_on`` (the train step's epoch gate)
    defers to the weight, as the JAX package's traced flag does."""
    slot = inputs["miss_slot"]
    gt_pos, pred_pos = inputs["gt_pos"], outputs["pred_pos"]
    reduce = ((lambda v, m: hard_neg_mean(v, m, hard_neg_ratio))
              if hard_neg else masked_mean)

    pos_loss = reduce((pred_pos - gt_pos).abs().mean(-1), slot)

    pair_valid = outputs["pair_valid"]
    pair_label = inputs["pair_label"][..., :pair_valid.shape[-1]]
    log_sm = masked_log_softmax(outputs["prob_logit"], pair_valid)
    has_label = (pair_label & pair_valid).any(-1)
    gt_slot, _ = masked_argmax(pair_label.float(), pair_valid)
    ce = -take_slot(log_sm, gt_slot)
    prob_loss = reduce(ce, slot & has_label)

    surf_norm_loss, angle_err, smooth_loss = surf_smooth_terms(
        inputs, pred_pos, train=train, img_hw=img_hw, hard_neg=hard_neg,
        hard_neg_ratio=hard_neg_ratio,
        want_smooth=bool(smooth_w) or smooth_on is True)

    def flag(v):
        return torch.as_tensor(v, dtype=torch.float32, device=pred_pos.device)

    loss_net = (pos_w * pos_loss + prob_w * prob_loss
                + surf_norm_w * flag(surf_norm_on) * surf_norm_loss
                + smooth_w * flag(smooth_on) * smooth_loss)

    pr_slot, _ = masked_argmax(outputs["prob_softmax"], pair_valid)
    acc = masked_mean((pr_slot == gt_slot).float(), slot)
    nz = (gt_pos.abs().sum(-1) != 0) & slot
    err = masked_mean(((pred_pos - gt_pos) ** 2).sum(-1).sqrt(), nz)
    return {"pos_loss": pos_loss, "prob_loss": prob_loss,
            "surf_norm_loss": surf_norm_loss, "smooth_loss": smooth_loss,
            "loss_net": loss_net, "acc": acc, "err": err,
            "angle_err": angle_err}
