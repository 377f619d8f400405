"""Stage-1 train and eval steps (counterpart of
``implicit_depth_tpu/train/steps.py``: the single step of
``_lidf_train_core`` and the one-shot ``make_lidf_eval_step``).

A train step is prepare_inputs (training rays) -> LIDFModel in train mode
(BatchNorm on batch statistics, the decode through K2/K3 on the card) ->
lidf_loss -> backward -> one optimizer update. Epoch-dependent switches
(the ``maxpool_label_epo`` curriculum, the ``surf_norm_epo`` /
``smooth_epo`` gates) are read from the epoch passed in. Like serving, the
steps run on ``cuda`` unless ``device="cpu"`` is asked for: the model is
moved there and each batch tensor is copied there (a no-op when it is
already on the device).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from implicit_depth_torch.infer import resolve_device
from implicit_depth_torch.models.lidf import LIDFModel, lidf_loss, prepare_inputs
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
