"""Train, eval and vis steps of both stages (counterpart of
``implicit_depth_tpu/train/steps.py``: the single steps of
``_lidf_train_core`` and ``_refine_train_core``, the one-shot
``make_lidf_eval_step`` and ``make_refine_eval_step``, and the vis steps).

A stage-1 train step is prepare_inputs (training rays) -> LIDFModel in
train mode (BatchNorm on batch statistics, the decode through K2/K3 on the
card) -> lidf_loss -> backward -> one optimizer update. A stage-2 step runs
the frozen stage 1 (eval mode, running BatchNorm statistics, no graph: the
serving K1) on the training rays, perturbs its prediction, runs
``refine.forward_times`` RefineNet iterations with the gradient flowing
from one into the next (K4 and K5 on the card), then refine_loss ->
backward -> one update of the refine parameters only. Epoch-dependent
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
from implicit_depth_torch.models.lidf import LIDFModel, lidf_loss, prepare_inputs
from implicit_depth_torch.models.refine import (
    RefineModel,
    refine_forward,
    refine_loss,
)
from implicit_depth_torch.train.state import TrainState

Tensors = Dict[str, torch.Tensor]


def _loss_kwargs(cfg, train: bool, epoch: int, device) -> dict:
    loss = cfg.loss

    def gate(on: bool) -> torch.Tensor:
        # a tensor, not a bool: lidf_loss then computes the smooth term only
        # when its weight is set, as the JAX step's traced flag does
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
    )


def _refine_loss_kwargs(cfg, train: bool, epoch: int, device) -> dict:
    kw = _loss_kwargs(cfg, train, epoch, device)
    del kw["prob_w"]  # stage 2 has no termination term
    return kw


def make_lidf_train_step(cfg, model: LIDFModel,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Callable:
    """Returns ``step(state, batch, generator, epoch) -> losses``.

    ``batch``: a batch dict (rgb, xyz, xyz_corrupt, depth_corrupt,
    corrupt_mask, valid_mask, fx, fy, cx, cy); ``generator`` draws the
    valid points and the miss-ray window (``valid_idx`` / ``miss_start``
    replace the draws). The parameters' gradients stay in ``.grad`` after
    the update; the returned losses are detached."""
    dev = resolve_device(device)
    model.to(dev)

    def step(state: TrainState, batch: Tensors,
             generator: Optional[torch.Generator], epoch: int,
             valid_idx: Optional[torch.Tensor] = None,
             miss_start: Optional[torch.Tensor] = None) -> Tensors:
        model.train()
        batch = {k: v.to(dev) for k, v in batch.items()}
        inputs = prepare_inputs(model.static, batch, train=True,
                                mask_type=cfg.mask_type, generator=generator,
                                valid_idx=valid_idx, miss_start=miss_start)
        use_gt = epoch < cfg.model.maxpool_label_epo
        out = model(inputs, use_gt_label=use_gt)
        losses = lidf_loss(inputs, out, **_loss_kwargs(cfg, True, epoch, dev))
        state.optimizer.zero_grad(set_to_none=True)
        losses["loss_net"].backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_lidf_eval_step(cfg, model: LIDFModel,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Callable:
    """Returns ``eval_step(state, batch, generator) -> (inputs, outputs,
    losses)``: every pixel a ray (``mask_type``), running BatchNorm
    statistics, no gradient, one shot (``tpu.eval_rays_per_chunk`` is not
    ported)."""
    if int(cfg.tpu.get("eval_rays_per_chunk", 0) or 0):
        raise NotImplementedError("chunked eval (tpu.eval_rays_per_chunk) "
                                  "is not ported")
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
        out = model(inputs)
        losses = lidf_loss(inputs, out, **_loss_kwargs(cfg, False, 10 ** 6,
                                                        dev))
        return inputs, out, losses

    return eval_step


def make_lidf_vis_step(cfg, model: LIDFModel,
                       device: Union[str, torch.device] = "cuda") -> Callable:
    """Returns ``vis_step(state, batch, generator) -> (inputs, pred_pos)``:
    the forward only, at the training shapes (sampled rays), with running
    BatchNorm statistics, for the train-time visualization."""
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
                                valid_idx=valid_idx, miss_start=miss_start)
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
                                valid_idx=valid_idx, miss_start=miss_start)
        with torch.no_grad():
            lidf_out = lidf(inputs,
                            use_gt_label=epoch < cfg.model.maxpool_label_epo)
        pred = refine_forward(refine_model, inputs, lidf_out, forward_times,
                              perturb=perturb, perturb_prob=perturb_prob,
                              generator=generator, noise=noise)
        losses = refine_loss(inputs, pred,
                             **_refine_loss_kwargs(cfg, True, epoch, dev))
        state.optimizer.zero_grad(set_to_none=True)
        losses["loss_net"].backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in losses.items()}

    return step


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
    one shot."""
    if int(cfg.tpu.get("eval_rays_per_chunk", 0) or 0):
        raise NotImplementedError("chunked eval (tpu.eval_rays_per_chunk) "
                                  "is not ported")
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
        lidf_out = lidf(inputs)
        pred = refine_forward(refine_model, inputs, lidf_out, forward_times,
                              inject_mask=_inject_mask(cfg, batch, inputs))
        losses = refine_loss(inputs, pred,
                             **_refine_loss_kwargs(cfg, False, 10 ** 6, dev))
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
                                valid_idx=valid_idx, miss_start=miss_start)
        lidf_out = lidf(inputs)
        return inputs, refine_forward(refine_model, inputs, lidf_out,
                                      forward_times)

    return vis_step
