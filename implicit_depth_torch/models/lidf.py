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
  and dense decodes take ``pair_decode_train``, K6 forward on the card and
  autograd of the plain version recomputed in the backward, as the JAX
  package trains them through autograd of its plain decode
  (``use_pallas_decode: false``); on the CPU the plain version under
  autograd. ``decode_bwd`` is unread in these modes, as in the JAX package.
  The kernels take the IEF offset decoder with positional encoding. With
  ``offdec_type`` IMNet or ``pos_encode`` false the config alone selects
  the JAX package's non-fused decode (``_embed_decode``: the embedding,
  then both decoders) in every mode, ``per_ray`` as the dense decode of
  the kb slots, in plain torch under autograd on any device;
  ``decode_bwd`` is then unread.
* :func:`lidf_loss` — position L1, per-ray termination cross-entropy,
  surface-normal and smoothness terms, and the metrics.
* :func:`split_rays` — a rank's block of the ray tensors under the mesh's
  ``rays`` axis (the JAX step's ``ray_sharding_constraints``): the model
  and the losses then run on the block, the image-level terms gathering
  the predictions along the split (``parallel/mesh.py::Split``).
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
from implicit_depth_torch.models.resnet import ResNet34_8s, remat
from implicit_depth_torch.ops.masked import (
    masked_argmax,
    masked_log_softmax,
    masked_softmax,
    take_slot,
)
from implicit_depth_torch.ops.pair_decode import (
    pair_decode,
    pair_decode_train,
    pair_decode_weights,
    prep_pair_decode_weights,
)
from implicit_depth_torch.ops.ray_decode import (
    prep_ray_decode_weights,
    ray_decode,
    ray_decode_train,
    split_ray_decode_weights,
)
from implicit_depth_torch.ops.ray_grid import ray_grid_intersect
from implicit_depth_torch.ops.roi_align import roi_window_pool
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.parallel.hardneg import sharded_hard_neg_mean
from implicit_depth_torch.utils import profiling

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


@profiling.spanned("lidf.prepare_inputs")
def prepare_inputs(static: LIDFStatic, batch: Tensors, train: bool = False,
                   mask_type: str = "all",
                   pred_mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   valid_idx: Optional[torch.Tensor] = None,
                   miss_start: Optional[torch.Tensor] = None,
                   shard=(0, 1)) -> Tensors:
    """Geometry stage: sampling, voxelization, ray/grid pairs, GT labels.

    batch: rgb (B,H,W,3) standardized; xyz / xyz_corrupt (B,H,W,3);
    depth_corrupt (B,H,W); corrupt_mask / valid_mask (B,H,W) {0,1};
    fx, fy, cx, cy (B,). Eval and serving (``train=False``): every pixel is
    a ray slot, the masks follow ``mask_type``. Training: the miss rays are
    ``static.n_rays`` slots of a random window of the corrupted pixels and
    the valid points come from ``valid_mask``. The random draws come from
    ``generator`` (at ``shard``, a rank's (rank, world):
    ``geometry/sampling.py::draw_uniform``); ``valid_idx`` (B, n_valid) and
    ``miss_start`` (B,) replace them with given ones."""
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
                                                 generator, shard=shard)
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
            start=miss_start, shard=shard)
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


# the (B, R[, ...]) inputs that a rank splits along the rays (the keys of the
# JAX step's ray_sharding_constraints, implicit_depth_tpu/train/steps.py:49);
# every other input is per image and stays whole
RAY_SPLIT_KEYS = ("miss_idx", "miss_slot", "miss_px", "miss_py", "miss_dir",
                  "miss_rgb", "gt_pos", "pair_cell", "pair_valid", "t_enter",
                  "t_exit", "pair_label")


def split_rays(inputs: Tensors, split) -> Tensors:
    """``inputs`` with each of :data:`RAY_SPLIT_KEYS` cut to the block of
    rays that ``split`` gives this rank (contiguous copies, so that a
    kernel reads the block from its start); ``inputs`` itself without a
    split of more than one block."""
    if not split or split.blocks == 1:
        return inputs
    s, e = split.bounds()
    return {**inputs, **{k: inputs[k][:, s:e].contiguous()
                         for k in RAY_SPLIT_KEYS}}


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
                 remat_backbone: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pairs_budget > 0 and pairs_budget_mode == "per_ray" \
                and pairs_budget < static.k_pairs:
            self.decode_mode = "per_ray"
        elif pairs_budget > 0 and pairs_budget_mode == "global":
            self.decode_mode = "global"
        else:
            self.decode_mode = "dense"
        self.static = static
        self.multires, self.multires_views = multires, multires_views
        self.pos_encode = pos_encode
        # the kernels decode the IEF offset decoder with positional encoding
        # (the JAX package's fused_ok / ray_major_ok); any other decoder
        # decodes in plain torch, on the card too, as JAX decodes it in XLA
        self.fused = pos_encode and offdec_type == "IEF"
        self.intersect_pos_type = intersect_pos_type
        self.n_iter, self.use_sigmoid = n_iter, use_sigmoid
        self.offset_range = tuple(offset_range)
        self.pairs_budget = pairs_budget
        self.decode_bwd = decode_bwd
        self.remat_backbone = remat_backbone
        self.dtype = dtype
        roi_dim = rgb_out * static.roi_out_bbox ** 2
        self.dims = {"c_vox": pnet_out, "c_roi": roi_dim,
                     "c_dir": posenc_dim(multires_views, enabled=pos_encode)}
        embed = pnet_out + roi_dim \
            + 2 * posenc_dim(multires, enabled=pos_encode) + self.dims["c_dir"]
        self.resnet = ResNet34_8s(out_ch=rgb_out, stage_sizes=resnet_stages,
                                  generator=generator)
        self.pnet = PointNet2Stage(out_channels=pnet_out, gf_dim=pnet_gf,
                                   generator=generator)
        if offdec_type == "IEF":
            self.offset_dec = IEF(embed, gf_dim=imnet_gf, n_iter=n_iter,
                                  use_sigmoid=use_sigmoid, generator=generator)
        else:
            self.offset_dec = IMNet(embed, gf_dim=imnet_gf,
                                    use_sigmoid=use_sigmoid,
                                    generator=generator)
        self.prob_dec = IMNet(embed, gf_dim=imnet_gf, use_sigmoid=use_sigmoid,
                              generator=generator)
        self._decode_w = PreparedWeights()
        self._pair_w = PreparedWeights()

    def decode_operands(self) -> Tensors:
        """K1's weight operands in the compute dtype at the kernels'
        widths, prepared once and reused while the decoder parameters and
        the dtype stay unchanged (serving and eval; detached)."""
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

    def pair_train_operands(self) -> Tensors:
        """K6's f32 operands of the training decode, from the live
        parameters on every call, as :meth:`train_operands`."""
        return pair_decode_weights(
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

    @profiling.spanned("lidf.trunk")
    def trunk(self, inputs: Tensors):
        """Per-image work shared by all rays: RGB features + voxel features.
        With ``remat_backbone`` the ResNet is checkpointed as one unit
        (``models/resnet.py::remat``: its activations recomputed in the
        backward, as the JAX package's ``nn.remat(ResNet34_8s)``)."""
        rgb = inputs["rgb"]
        feat_map = (remat(self.resnet, rgb, self.dtype) if self.remat_backbone
                    else self.resnet(rgb, self.dtype))
        return feat_map, self.voxel_features(inputs)

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
        kernel, not decoded): the kernel in eval mode; in train mode
        ``pair_decode_train`` at operands from the live parameters (K6
        forward and the plain decode's recompute backward on the card, the
        plain version under autograd on the CPU)."""
        if not self.fused:
            return self._embed_decode(vox_feat, cells, pos, ray_feat, rays)
        kw = dict(n_rows=n_rows, n_iter=self.n_iter,
                  init_offset=self.offset_dec.init_offset,
                  use_sigmoid=self.use_sigmoid)
        if not self.training:
            return pair_decode(vox_feat, cells, pos, ray_feat,
                               self.pair_operands(), rays, **kw)
        return pair_decode_train(vox_feat, cells, pos, ray_feat,
                                 self.pair_train_operands(), rays,
                                 dtype=self.dtype, **kw)

    def _embed_decode(self, vox_feat, cells, pos, ray_feat, rays=None):
        """The decode of pair rows without a kernel, for the decoders the
        kernels do not take (the JAX package's ``_embed_and_decode`` when
        ``fused_ok`` is false): each row's embedding [vox | roi |
        posenc(enter) | posenc(leave) | posenc(dir)] in the compute dtype,
        then both decoders; the arguments as :meth:`_decode_pairs` takes
        them. Plain torch under autograd, on any device."""
        p, n = cells.shape[0], ray_feat.shape[0]
        rows = (ray_feat.repeat_interleave(p // n, 0) if rays is None
                else ray_feat[rays.long()])
        c_roi, dt = self.dims["c_roi"], self.dtype
        enter_e, leave_e = (positional_encoding(pos[:, s:s + 3], self.multires,
                                                self.pos_encode)
                            for s in (0, 3))
        embed = torch.cat([vox_feat[cells.long()].to(dt), rows[:, :c_roi],
                           enter_e.to(dt), leave_e.to(dt), rows[:, c_roi:]],
                          -1)
        return (self.offset_dec(embed, dt)[..., 0],
                self.prob_dec(embed, dt)[..., 0])

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

    def _decode_compacted(self, inputs, vox_feat, ray_feat, whole=None):
        """The ``global`` mode (``_decode_compacted`` of the JAX package):
        the valid slots ranked k-major (every ray's nearest pair before any
        second-nearest), the first P = min(B·R·pairs_budget, B·R·K) taken,
        the results scattered back (the selection in the span
        ``lidf.compact_pairs``). The valid rows are the prefix of
        min(valid slots, P) rows, counted on the device: only those are
        decoded (the JAX package decodes the pad rows too, at slot 0, and
        zeroes them; the outputs are the same). Returns (offset, logit,
        decoded), each (B, R, K).

        ``whole`` (pair_valid (B', R', K) of the global batch, row0, ray0):
        ``inputs`` hold the block of rows [row0, row0 + B) and rays [ray0,
        ray0 + R) of that batch. The selection is then the global batch's,
        and of its rows the block's are decoded: moved to the front in
        selection order, their count the row count."""
        b, r, k = inputs["pair_valid"].shape
        dev = vox_feat.device
        n_slots = b * r * k
        pv_all, row0, ray0 = (inputs["pair_valid"], 0, 0) if whole is None \
            else whole
        bt, rt = pv_all.shape[:2]
        n_all = bt * rt * k
        p = min(bt * rt * self.pairs_budget, n_all)
        with profiling.span("lidf.compact_pairs"):
            valid_km = pv_all.permute(2, 0, 1).reshape(-1)
            rank = torch.cumsum(valid_km.long(), 0) - 1
            rank = torch.where(valid_km & (rank < p), rank,
                               torch.full_like(rank, p))
            # slot p takes every dropped index and is cut off
            sel = torch.full((p + 1,), n_all, dtype=torch.long,
                             device=dev).scatter_(
                0, rank, torch.arange(n_all, device=dev))[:p]
            sel_valid = sel < n_all
            sel = torch.where(sel_valid, sel, torch.zeros_like(sel))
            if whole is None:
                sel_ray = sel % (b * r)                  # flat b·R + r
                slot = sel // (b * r)
                # the valid prefix's length, with no host sync
                n_rows = valid_km.sum().clamp(max=p).to(torch.int32)
            else:
                gb = torch.div(sel % (bt * rt), rt,
                               rounding_mode="floor") - row0
                gr = sel % rt - ray0
                mine = (sel_valid & (gb >= 0) & (gb < b) & (gr >= 0)
                        & (gr < r))
                n_mine = mine.sum()
                dest = torch.where(mine, torch.cumsum(mine, 0) - 1,
                                   n_mine + torch.cumsum(~mine, 0) - 1)
                src = torch.empty_like(sel).scatter_(
                    0, dest, torch.arange(p, device=dev))
                sel_valid = mine[src]
                sel_ray = torch.where(sel_valid, (gb * r + gr)[src],
                                      torch.zeros_like(sel))
                slot = torch.where(
                    sel_valid,
                    torch.div(sel, bt * rt, rounding_mode="floor")[src],
                    torch.zeros_like(sel))
                n_rows = n_mine.to(torch.int32)
            row = sel_ray * k + slot                     # row-major (B, R, K)
            cells = (torch.div(sel_ray, r, rounding_mode="floor")
                     * self.static.grid.n_cells
                     + inputs["pair_cell"].reshape(-1)[row])
            enter, leave = self._pair_positions(inputs)
            pos = torch.cat([enter, leave], -1).float().reshape(-1, 6)[row]
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

    @profiling.spanned("lidf.decode_rays")
    def decode_rays(self, inputs: Tensors, feat_map: torch.Tensor,
                    vox_feat: torch.Tensor, use_gt_label=False,
                    whole=None) -> Tensors:
        """Per-ray work: ROI pooling, the pair decode of ``decode_mode``,
        per-ray softmax/argmax, predicted position. Outputs are (B, R, kb)
        in the ``per_ray`` mode, (B, R, K) in the others. In train mode the
        slot is the labelled one while ``use_gt_label`` (the
        ``maxpool_label_epo`` curriculum), else the most probable. Every
        ray's outputs depend on its own inputs only, so a block of rays
        decodes as it does in the whole; but the ``global`` mode's budget
        is the batch's, and a block of it takes ``whole``
        (:meth:`_decode_compacted`)."""
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
        dir_e = positional_encoding(dirs, self.multires_views, self.pos_encode)
        ray_feat = torch.cat([roi.to(self.dtype), dir_e.to(self.dtype)],
                             -1).reshape(b * r, -1)

        if self.decode_mode == "per_ray":
            # the pair slots are t-sorted and front-packed: the first kb
            # slots are each ray's nearest pairs, a dense (B, R, kb) block
            sliced = {k: inputs[k][:, :, :kb] for k in
                      ("pair_cell", "pair_valid", "t_enter", "t_exit",
                       "pair_label")}
            sliced["miss_dir"] = dirs
            pair_valid = sliced["pair_valid"]
        if self.decode_mode == "per_ray" and not self.fused:
            # the JAX package's non-fused per_ray decode: the dense decode
            # of the (B, R, kb) block
            pred_offset, prob_logit = self._decode_dense(sliced, vox_feat,
                                                         ray_feat)
        elif self.decode_mode == "per_ray":
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
                off, logit = ray_decode(vox_feat, cells, pos, ray_feat,
                                        self.decode_operands(), **kw)
            pred_offset = off.reshape(b, r, kb)
            prob_logit = logit.reshape(b, r, kb)
        else:
            sliced = inputs
            if self.decode_mode == "global":
                pred_offset, prob_logit, decoded = self._decode_compacted(
                    inputs, vox_feat, ray_feat, whole)
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

    def forward(self, inputs: Tensors, use_gt_label=False,
                whole=None) -> Tensors:
        feat_map, vox_feat = self.trunk(inputs)
        out = self.decode_rays(inputs, feat_map, vox_feat, use_gt_label,
                               whole)
        return {**out, "feat_map": feat_map, "vox_feat": vox_feat}


# ---------------------------------------------------------------------------
# Loss (counterpart of the JAX package's lidf_loss and its helpers)
# ---------------------------------------------------------------------------

def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                sharded=False) -> torch.Tensor:
    """The mean of the masked values; ``sharded`` (True or a
    ``mesh.Split``): this rank's share of the global batch's, its own sum
    over the count all-reduced over every rank (detached)."""
    num = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device)).sum()
    count = mask.to(x.dtype).sum()
    if sharded:
        count = mesh.all_reduce_sum(count)
    return num / count.clamp(min=1.0)


def hard_neg_mean(x: torch.Tensor, mask: torch.Tensor, ratio: float,
                  sharded=False) -> torch.Tensor:
    """Mean of the top-``ratio`` fraction of the masked values;
    ``sharded`` (True: the train step's split, or a ``mesh.Split``): this
    rank's share of the global batch's (``parallel/hardneg.py``)."""
    if sharded:
        return sharded_hard_neg_mean(
            x, mask, ratio, None if sharded is True else sharded)
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
    """``values`` (B, R, C) of every ray slot written into the (B, H·W, C)
    image ``base_flat`` at their pixels. Eval rays are pixel-aligned (a
    select over the ray mask, ``miss_mask_flat``, which is every pixel's
    ``miss_slot``); training rays are window slots, so pixel p takes slot
    rank(p) - start: one gather, whose gradient reaches each slot from its
    own pixel."""
    if not train:
        return torch.where(inputs["miss_mask_flat"][..., None], values,
                           base_flat)
    rank, start = inputs["miss_rank"], inputs["miss_start"]
    r = values.shape[1]
    in_win = window_in_mask(inputs["miss_mask_flat"], rank, start, r)
    j = (rank - start[:, None]).clamp(0, r - 1).long()
    vals = values.gather(1, j[..., None].expand(-1, -1, values.shape[-1]))
    return torch.where(in_win[..., None], vals, base_flat)


def mean_fns(hard_neg: bool, hard_neg_ratio: float, sharded):
    """(the loss terms' reduction, masked_mean), both over the global batch
    under ``sharded``."""
    def mean(v, m):
        return masked_mean(v, m, sharded)

    def hard(v, m):
        return hard_neg_mean(v, m, hard_neg_ratio, sharded)

    return (hard if hard_neg else mean), mean


def surf_smooth_terms(inputs: Tensors, pred_pos: torch.Tensor, *, train: bool,
                      img_hw, hard_neg: bool, hard_neg_ratio: float,
                      want_smooth: bool, sharded=False):
    """(surf_norm_loss, angle_err, smooth_loss) over the miss pixels, from
    the channel-planar normals of the GT and the predicted point images;
    smooth_loss is 0 unless ``want_smooth``.

    Under a ``mesh.Split`` of the rays (``sharded``) ``pred_pos`` and the
    ray inputs are this rank's block: the image is composed from the
    predictions of every block (gathered, with their gradient), and the
    rank's share of each mean is taken over the pixels of its own block's
    slots, so that the ranks' shares sum to the whole image's term."""
    h, w = img_hw
    slot = inputs["miss_slot"]
    b = slot.shape[0]
    reduce, mean = mean_fns(hard_neg, hard_neg_ratio, sharded)
    split = sharded if isinstance(sharded, mesh.Split) else None
    pred_all = split.gather(pred_pos) if split is not None else pred_pos
    r = pred_all.shape[1]
    s0, s1 = split.bounds() if split is not None else (0, r)
    base = inputs["xyz_flat"] if train else inputs["xyz_corrupt_flat"]
    # train: gt_pos is xyz_flat gathered at miss_idx, so writing it back
    # into xyz_flat is the identity; eval: gt_pos is xyz_flat (every pixel
    # a ray slot)
    gt_rows = base if train else compose_pred_image(
        base, inputs["xyz_flat"], inputs, train)
    pr_rows = compose_pred_image(base, pred_all, inputs, train)

    def planar(rows):
        return rows.reshape(b, h, w, 3).permute(0, 3, 1, 2)

    gt_n, _, _ = surface_normals_planar(planar(gt_rows))
    pr_n, dx, dy = surface_normals_planar(planar(pr_rows))
    cos_img = (gt_n * pr_n).sum(1).reshape(b, h * w)
    dist_img = (1.0 - cos_img) / 2.0
    # the pixels of this rank's slots [s0, s1): a window slot's index is
    # its pixel's rank - start, an eval slot's its pixel
    if train:
        j = inputs["miss_rank"] - inputs["miss_start"][:, None]
        in_win = inputs["miss_mask_flat"] & (j >= s0) & (j < s1)
    else:
        j = torch.arange(h * w, device=slot.device)
        in_win = inputs["miss_mask_flat"] & (j >= s0) & (j < s1)
    angle = (mean(torch.arccos(cos_img.clamp(-1, 1)), in_win)
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
        surf = mean(dist_img, in_win)
        smooth = (mean(dx2, in_win) + mean(dy2, in_win)
                  if want_smooth else zero)
    return surf, angle, smooth


def lidf_loss(inputs: Tensors, outputs: Tensors, *, train: bool, img_hw,
              pos_w: float = 100.0, prob_w: float = 0.5,
              surf_norm_w: float = 10.0, smooth_w: float = 0.0,
              surf_norm_on=True, smooth_on=True, hard_neg: bool = False,
              hard_neg_ratio: float = 0.1, sharded=False) -> Tensors:
    """Position L1, per-ray termination CE, surface-normal and smoothness
    terms (``loss_net``) and the metrics acc, err, angle_err. The smooth
    term is computed when ``smooth_w`` is set or ``smooth_on`` is the
    literal True; a tensor ``smooth_on`` (the train step's epoch gate)
    defers to the weight, as the JAX package's traced flag does.

    ``sharded`` (a rank's block of the global batch: True, a block of its
    images, or a ``mesh.Split``, a block of its images and of their rays):
    every value is the rank's share of the global batch's, so that the
    shares sum over the ranks to the 1-process loss and metrics, and their
    gradients to its gradient."""
    slot = inputs["miss_slot"]
    gt_pos, pred_pos = inputs["gt_pos"], outputs["pred_pos"]
    reduce, mean = mean_fns(hard_neg, hard_neg_ratio, sharded)

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
        want_smooth=bool(smooth_w) or smooth_on is True, sharded=sharded)

    def flag(v):
        return torch.as_tensor(v, dtype=torch.float32, device=pred_pos.device)

    loss_net = (pos_w * pos_loss + prob_w * prob_loss
                + surf_norm_w * flag(surf_norm_on) * surf_norm_loss
                + smooth_w * flag(smooth_on) * smooth_loss)

    pr_slot, _ = masked_argmax(outputs["prob_softmax"], pair_valid)
    acc = mean((pr_slot == gt_slot).float(), slot)
    nz = (gt_pos.abs().sum(-1) != 0) & slot
    err = mean(((pred_pos - gt_pos) ** 2).sum(-1).sqrt(), nz)
    return {"pos_loss": pos_loss, "prob_loss": prob_loss,
            "surf_norm_loss": surf_norm_loss, "smooth_loss": smooth_loss,
            "loss_net": loss_net, "acc": acc, "err": err,
            "angle_err": angle_err}
