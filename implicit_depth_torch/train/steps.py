"""Train, eval and vis steps of both stages (counterpart of
``implicit_depth_tpu/train/steps.py``: the single steps of
``_lidf_train_core`` and ``_refine_train_core``, ``make_lidf_eval_step``
(one shot, or the per-ray decode over chunks of ``tpu.eval_rays_per_chunk``
rays), ``make_refine_eval_step`` and the vis steps).

A stage-1 train step is prepare_inputs (training rays) -> LIDFModel in
train mode (BatchNorm on batch statistics, the decode through K2/K3 on the
card) -> lidf_loss -> backward -> one optimizer update. A stage-2 step runs
the frozen stage 1 (eval mode, running BatchNorm statistics, no graph: the
serving K1) on the training rays, perturbs its prediction, runs
``refine.forward_times`` RefineNet iterations with the gradient flowing
from one into the next (K4 and K5 on the card), then refine_loss ->
backward -> one update of the refine parameters only. Under a process
group (``parallel/mesh.py``) a train step runs on the rank's block of the
global batch under the ``("data", "rays")`` layout: its draws are the
global batch's rows of its data block, it decodes its block of those
images' rays (``models/lidf.py::split_rays``; the trunk whole, as every
rank of its rays group computes it), its loss is its share of the global
loss (the BatchNorm statistics, normalisers and hard-negative top-k
global; the image-level terms over the gathered predictions), and its
gradients are summed over the ranks before the update, so that every rank
makes the update of one process on the global batch. In stage 2 the
frozen stage 1 decodes the block, its outputs are gathered, and each
RefineNet iteration voxelises every point of the image and decodes the
block. The eval steps split each frame's rays over every rank (every rank
evaluates the same frames; the outputs are gathered, the losses are the
ranks' shares); the vis steps draw as the train steps do, so that every
rank, running them, keeps its generator in step. Epoch-dependent
switches (the ``maxpool_label_epo`` curriculum, the ``surf_norm_epo`` /
``smooth_epo`` gates) are read from the epoch passed in. Like serving, the
steps run on ``cuda`` unless ``device="cpu"`` is asked for: the models are
moved there and each batch tensor is copied there (a no-op when it is
already on the device).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from implicit_depth_torch.infer import resolve_device
from implicit_depth_torch.models.lidf import (
    LIDFModel,
    lidf_loss,
    prepare_inputs,
    split_rays,
)
from implicit_depth_torch.models.refine import (
    RefineModel,
    refine_forward,
    refine_loss,
)
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.utils import profiling

Tensors = Dict[str, torch.Tensor]


def _loss_kwargs(cfg, train: bool, epoch: int, device, sharded=False) -> dict:
    loss = cfg.loss

    def gate(on: bool) -> torch.Tensor:
        # a tensor, not a bool: lidf_loss then computes the smooth term only
        # when its weight is set, as the JAX step's traced flag does
        with profiling.span("sync.loss_gates"):  # a pageable copy
            return torch.tensor(on, device=device)

    return dict(
        train=train,
        img_hw=(cfg.dataset.img_height, cfg.dataset.img_width),
        pos_w=loss.pos_w,
        prob_w=loss.prob_w,
        surf_norm_w=loss.surf_norm_w,
        smooth_w=loss.smooth_w,
        surf_norm_on=gate(epoch >= loss.surf_norm_epo),
        smooth_on=gate(epoch >= loss.smooth_epo),
        hard_neg=bool(loss.hard_neg),
        hard_neg_ratio=float(loss.hard_neg_ratio or 0.1),
        sharded=sharded,
    )


def _refine_loss_kwargs(cfg, train: bool, epoch: int, device,
                        sharded=False) -> dict:
    kw = _loss_kwargs(cfg, train, epoch, device, sharded)
    del kw["prob_w"]  # stage 2 has no termination term
    return kw


def _split(train: bool, n: int):
    """This rank's split of ``n`` rays an image: the train step's under the
    layout, the eval step's over every rank; False (no split) without a
    group of several ranks."""
    if mesh.world() == 1:
        return False
    return mesh.train_split(n) if train else mesh.eval_split(n)


def _whole(model: LIDFModel, inputs: Tensors, split, train: bool):
    """The ``global`` decode's view of the global batch for a block
    (``LIDFModel._decode_compacted``): the pair slots of every image of it
    (a train step's data blocks gathered from each rays group's first
    rank), and the block's first row and ray."""
    if model.decode_mode != "global" or not split:
        return None
    pv = inputs["pair_valid"]
    if train and split.rows > 1:
        lay = mesh.current()
        every = mesh.all_gather(pv.to(torch.uint8))
        firsts = sorted((d, r) for r, (d, ri) in enumerate(lay.coords)
                        if ri == 0)
        pv = every[[r for _, r in firsts]].flatten(0, 1).bool()
    return pv, split.row * inputs["pair_valid"].shape[0], split.bounds()[0]


def gather_outputs(out: Tensors, split) -> Tensors:
    """The per-ray outputs of a block joined along the rays of every block
    (``feat_map`` and ``vox_feat`` are per image and stay)."""
    if not split or split.blocks == 1:
        return out
    return {k: (v if k in ("feat_map", "vox_feat") else split.gather(v))
            for k, v in out.items()}


def make_lidf_train_step(cfg, model: LIDFModel,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Callable:
    """Returns ``step(state, batch, generator, epoch) -> losses``.

    ``batch``: a batch dict (rgb, xyz, xyz_corrupt, depth_corrupt,
    corrupt_mask, valid_mask, fx, fy, cx, cy); ``generator`` draws the
    valid points and the miss-ray window (``valid_idx`` / ``miss_start``
    replace the draws). Under a group, ``batch`` is the rank's data block
    of the global batch (``valid_idx`` / ``miss_start`` its rows too) and
    the losses are its shares. The parameters' gradients stay in ``.grad``
    after the update; the returned losses are detached."""
    dev = resolve_device(device)
    model.to(dev)

    @profiling.spanned("train.step")
    def step(state: TrainState, batch: Tensors,
             generator: Optional[torch.Generator], epoch: int,
             valid_idx: Optional[torch.Tensor] = None,
             miss_start: Optional[torch.Tensor] = None) -> Tensors:
        model.train()
        batch = {k: v.to(dev) for k, v in batch.items()}
        inputs = prepare_inputs(model.static, batch, train=True,
                                mask_type=cfg.mask_type, generator=generator,
                                valid_idx=valid_idx, miss_start=miss_start,
                                shard=mesh.shard())
        split = _split(True, inputs["pair_valid"].shape[1])
        use_gt = epoch < cfg.model.maxpool_label_epo
        blk = split_rays(inputs, split)
        out = model(blk, use_gt_label=use_gt,
                    whole=_whole(model, inputs, split, True))
        with profiling.span("train.loss"):
            losses = lidf_loss(blk, out, **_loss_kwargs(cfg, True, epoch, dev,
                                                         split))
        with profiling.span("train.backward", adopt=True):
            state.optimizer.zero_grad(set_to_none=True)
            losses["loss_net"].backward()
            mesh.all_reduce_grads(model.parameters())
        with profiling.span("train.optimizer"):
            state.apply_gradients()
        return {k: v.detach() for k, v in losses.items()}

    return step


# the ray-axis inputs LIDFModel.decode_rays reads, which the chunked eval
# splits (the JAX step's _RAY_KEYS)
RAY_KEYS = ("miss_px", "miss_py", "miss_dir", "pair_cell", "pair_valid",
            "t_enter", "t_exit", "pair_label")


def chunked_forward(model: LIDFModel, inputs: Tensors, chunk: int) -> Tensors:
    """The eval forward with the trunk run once and the per-ray decode over
    consecutive chunks of ``chunk`` rays (the JAX step's
    ``_chunked_forward``): the last chunk padded with zeros, the padding
    cut from the joined outputs. Each ray's decode depends on its own rows
    only, so the outputs are those of one shot."""
    feat_map, vox_feat = model.trunk(inputs)
    r = inputs["pair_valid"].shape[1]
    n_chunks = -(-r // chunk)
    pad = n_chunks * chunk - r

    def part(x, i):  # (B, R, ...) -> (B, chunk, ...) of chunk i
        x = x[:, i * chunk:(i + 1) * chunk]
        if x.shape[1] < chunk:
            x = torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], 1)
        return x

    outs = [model.decode_rays({**inputs, **{k: part(inputs[k], i)
                                            for k in RAY_KEYS}},
                              feat_map, vox_feat)
            for i in range(n_chunks)]
    out = {k: torch.cat([o[k] for o in outs], 1)[:, :r] for k in outs[0]}
    return {**out, "feat_map": feat_map, "vox_feat": vox_feat}


def make_lidf_eval_step(cfg, model: LIDFModel,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Callable:
    """Returns ``eval_step(state, batch, generator) -> (inputs, outputs,
    losses)``: every pixel a ray (``mask_type``), running BatchNorm
    statistics, no gradient; the per-ray decode over chunks of
    ``tpu.eval_rays_per_chunk`` rays when that is set and below the ray
    count (:func:`chunked_forward`), else one shot. Under a group each
    rank decodes its block of every frame's rays (chunked within the
    block), the outputs are gathered along the rays and the losses are
    the rank's shares; ``inputs`` are the whole frame's."""
    chunk = int(cfg.tpu.get("eval_rays_per_chunk", 0) or 0)
    dev = resolve_device(device)
    model.to(dev)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Tensors,
                  generator: Optional[torch.Generator] = None,
                  valid_idx: Optional[torch.Tensor] = None):
        model.eval()
        batch = {k: v.to(dev) for k, v in batch.items()}
        inputs = prepare_inputs(model.static, batch, train=False,
                                mask_type=cfg.mask_type,
                                pred_mask=batch.get("pred_mask"),
                                generator=generator, valid_idx=valid_idx)
        split = _split(False, inputs["pair_valid"].shape[1])
        blk = split_rays(inputs, split)
        if chunk and chunk < blk["pair_valid"].shape[1]:
            out = chunked_forward(model, blk, chunk)
        else:
            out = model(blk, whole=_whole(model, inputs, split, False))
        losses = lidf_loss(blk, out, **_loss_kwargs(cfg, False, 10 ** 6,
                                                     dev, split))
        return inputs, gather_outputs(out, split), losses

    return eval_step


def make_lidf_vis_step(cfg, model: LIDFModel,
                       device: Union[str, torch.device] = "cuda") -> Callable:
    """Returns ``vis_step(state, batch, generator) -> (inputs, pred_pos)``:
    the forward only, at the training shapes (sampled rays, drawn at the
    rank's shard), with running BatchNorm statistics, for the train-time
    visualization."""
    dev = resolve_device(device)
    model.to(dev)

    @torch.no_grad()
    def vis_step(state: TrainState, batch: Tensors,
                 generator: Optional[torch.Generator],
                 valid_idx: Optional[torch.Tensor] = None,
                 miss_start: Optional[torch.Tensor] = None):
        model.eval()
        batch = {k: v.to(dev) for k, v in batch.items()}
        inputs = prepare_inputs(model.static, batch, train=True,
                                mask_type=cfg.mask_type, generator=generator,
                                valid_idx=valid_idx, miss_start=miss_start,
                                shard=mesh.shard())
        return inputs, model(inputs)["pred_pos"]

    return vis_step


def _frozen(lidf_model: LIDFModel, dev) -> LIDFModel:
    """The stage-1 model on ``dev``, frozen: no parameter asks for a
    gradient, and it runs in eval mode (running BatchNorm statistics)."""
    return lidf_model.to(dev).requires_grad_(False).eval()


def make_refine_train_step(cfg, lidf_model: LIDFModel,
                           refine_model: RefineModel,
                           device: Union[str, torch.device] = "cuda"
                           ) -> Callable:
    """Returns ``step(state, batch, generator, epoch) -> losses``; ``state``
    holds the refine model and its optimizer (the frozen stage 1 is never
    handed to it).

    ``generator`` draws the valid points, the miss-ray window and the
    perturbation's three uniforms; ``valid_idx`` / ``miss_start`` and
    ``noise`` ({apply, bucket, u}, each (B,)) replace the draws. The refine
    parameters' gradients stay in ``.grad`` after the update; the returned
    losses are detached."""
    dev = resolve_device(device)
    lidf = _frozen(lidf_model, dev)
    refine_model.to(dev)
    forward_times = int(cfg.refine.forward_times)
    perturb = bool(cfg.refine.perturb)
    perturb_prob = float(cfg.refine.perturb_prob)

    @profiling.spanned("train.step")
    def step(state: TrainState, batch: Tensors,
             generator: Optional[torch.Generator], epoch: int,
             valid_idx: Optional[torch.Tensor] = None,
             miss_start: Optional[torch.Tensor] = None,
             noise: Optional[Tensors] = None) -> Tensors:
        lidf.eval()
        refine_model.train()
        batch = {k: v.to(dev) for k, v in batch.items()}
        inputs = prepare_inputs(lidf.static, batch, train=True,
                                mask_type=cfg.mask_type, generator=generator,
                                valid_idx=valid_idx, miss_start=miss_start,
                                shard=mesh.shard())
        split = _split(True, inputs["pair_valid"].shape[1])
        blk = split_rays(inputs, split)
        with torch.no_grad():
            lidf_out = gather_outputs(lidf(
                blk, use_gt_label=epoch < cfg.model.maxpool_label_epo,
                whole=_whole(lidf, inputs, split, True)), split)
        pred = refine_forward(refine_model, inputs, lidf_out, forward_times,
                              perturb=perturb, perturb_prob=perturb_prob,
                              generator=generator, noise=noise,
                              shard=mesh.shard(), split=_ray_split(split))
        with profiling.span("train.loss"):
            losses = refine_loss(blk, pred,
                                 **_refine_loss_kwargs(cfg, True, epoch, dev,
                                                       split))
        with profiling.span("train.backward", adopt=True):
            state.optimizer.zero_grad(set_to_none=True)
            losses["loss_net"].backward()
            mesh.all_reduce_grads(refine_model.parameters())
        with profiling.span("train.optimizer"):
            state.apply_gradients()
        return {k: v.detach() for k, v in losses.items()}

    return step


def _ray_split(split):
    """``split`` where it splits the rays, else None."""
    return split if split and split.blocks > 1 else None


def _inject_mask(cfg, batch: Tensors, inputs: Tensors):
    """The ``refine.use_all_pix: false`` eval rule: with every pixel a ray,
    only the zero-input-depth pixels' predictions enter the PointNet."""
    if cfg.mask_type != "all" or bool(cfg.refine.use_all_pix):
        return None
    depth = batch["depth_corrupt"]
    zero_flat = depth.reshape(depth.shape[0], -1) == 0
    return zero_flat.gather(1, inputs["miss_idx"].long())


def make_refine_eval_step(cfg, lidf_model: LIDFModel,
                          refine_model: RefineModel,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Callable:
    """Returns ``eval_step(state, batch, generator) -> (inputs, lidf_out,
    pred, losses)``: every pixel a ray (``mask_type``), both stages without
    a gradient, ``refine.forward_times`` iterations with no perturbation,
    one shot (the JAX step reads no ``tpu.eval_rays_per_chunk`` either).
    Under a group each rank decodes its block of the rays in both stages,
    as :func:`make_lidf_eval_step`."""
    dev = resolve_device(device)
    lidf = _frozen(lidf_model, dev)
    refine_model.to(dev)
    forward_times = int(cfg.refine.forward_times)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Tensors,
                  generator: Optional[torch.Generator] = None,
                  valid_idx: Optional[torch.Tensor] = None):
        lidf.eval()
        refine_model.eval()
        batch = {k: v.to(dev) for k, v in batch.items()}
        inputs = prepare_inputs(lidf.static, batch, train=False,
                                mask_type=cfg.mask_type,
                                pred_mask=batch.get("pred_mask"),
                                generator=generator, valid_idx=valid_idx)
        split = _split(False, inputs["pair_valid"].shape[1])
        blk = split_rays(inputs, split)
        lidf_out = gather_outputs(
            lidf(blk, whole=_whole(lidf, inputs, split, False)), split)
        pred = refine_forward(refine_model, inputs, lidf_out, forward_times,
                              inject_mask=_inject_mask(cfg, batch, inputs),
                              split=_ray_split(split))
        losses = refine_loss(blk, pred,
                             **_refine_loss_kwargs(cfg, False, 10 ** 6, dev,
                                                   split))
        pred = split.gather(pred) if _ray_split(split) else pred
        return inputs, lidf_out, pred, losses

    return eval_step


def make_refine_vis_step(cfg, lidf_model: LIDFModel,
                         refine_model: RefineModel,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Callable:
    """Returns ``vis_step(state, batch, generator) -> (inputs, pred)``: the
    stage-2 :func:`make_lidf_vis_step`, ``refine.forward_times`` iterations
    at the training shapes, no perturbation, no gradient."""
    dev = resolve_device(device)
    lidf = _frozen(lidf_model, dev)
    refine_model.to(dev)
    forward_times = int(cfg.refine.forward_times)

    @torch.no_grad()
    def vis_step(state: TrainState, batch: Tensors,
                 generator: Optional[torch.Generator],
                 valid_idx: Optional[torch.Tensor] = None,
                 miss_start: Optional[torch.Tensor] = None):
        lidf.eval()
        refine_model.eval()
        batch = {k: v.to(dev) for k, v in batch.items()}
        inputs = prepare_inputs(lidf.static, batch, train=True,
                                mask_type=cfg.mask_type, generator=generator,
                                valid_idx=valid_idx, miss_start=miss_start,
                                shard=mesh.shard())
        lidf_out = lidf(inputs)
        return inputs, refine_forward(refine_model, inputs, lidf_out,
                                      forward_times)

    return vis_step
