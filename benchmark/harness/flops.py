"""The model's operations a served call or a training step: the products
and convolutions of the plain reference at the cell's shapes, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device (no data,
no time on the card). A step counts the trained model's forward and
backward; a frozen stage 1 counts its forward only."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import geometry
from benchmark.reference import model as ref

META = torch.device("meta")


def _params(spec, grad=False):
    return {n: torch.empty(s, device=META, requires_grad=grad and not
                           n.endswith(("running_mean", "running_var",
                                       "num_batches_tracked")))
            for n, s in spec}


def _batch(b, h, w):
    z = {k: torch.empty((b, h, w, 3), device=META)
         for k in ("rgb", "xyz", "xyz_corrupt")}
    z.update({k: torch.empty((b, h, w), device=META)
              for k in ("depth_corrupt", "corrupt_mask", "valid_mask")})
    z.update({k: torch.empty((b,), device=META)
              for k in ("fx", "fy", "cx", "cy")})
    return z


def _cfg(cfg):
    return {**cfg, "_grid": geometry.make_grid(cfg["grid"]["res"])}


def serve(cfg: dict, traffic: dict) -> float:
    c = _cfg(cfg)
    p1, p2 = _params(ref.lidf_spec(cfg)), _params(ref.refine_spec(cfg)) \
        if "refine" in cfg else None
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        inp = geometry.prepare(c["_grid"], _batch(traffic["batch"],
                                                  traffic["height"],
                                                  traffic["width"]),
                               train=False,
                               n_valid=cfg["grid"]["valid_sample_num"],
                               n_rays=0,
                               k_pairs=cfg["tpu"]["max_pairs_per_ray"],
                               gen=None)
        prec = ref.Precision()
        s1 = ref.lidf_forward(p1, c, inp, train=False, use_gt=False,
                              prec=prec)
        if p2:
            ref.refine_forward(p2, c, inp, s1, prec)
    return float(fc.get_total_flops())


def train(cfg: dict, traffic: dict, stage: str, epoch: int) -> float:
    c = _cfg(cfg)
    hw = (traffic["height"], traffic["width"])
    prec = ref.Precision()
    p1 = _params(ref.lidf_spec(cfg), grad=stage == "lidf")
    p2 = _params(ref.refine_spec(cfg), grad=True) if stage == "refine" \
        else None
    with FlopCounterMode(display=False) as fc:
        inp = geometry.prepare(c["_grid"], _batch(traffic["batch"], *hw),
                               train=True,
                               n_valid=cfg["grid"]["valid_sample_num"],
                               n_rays=cfg["grid"]["miss_sample_num"],
                               k_pairs=cfg["tpu"]["max_pairs_per_ray"],
                               gen=None)
        if stage == "lidf":
            out = ref.lidf_forward(
                p1, c, inp, train=True,
                use_gt=epoch < cfg["model"]["maxpool_label_epo"], prec=prec)
            loss = ref.lidf_loss(inp, out, cfg["loss"], hw, epoch)
            leaves = p1
        else:
            with torch.no_grad():
                s1 = ref.lidf_forward(p1, c, inp, train=False, use_gt=False,
                                      prec=prec)
            pred = ref.refine_forward(p2, c, inp, s1, prec, None,
                                      bool(cfg["refine"]["perturb"]))
            loss = ref.refine_loss(inp, pred, cfg["loss"], hw, epoch)
            leaves = p2
        torch.autograd.grad(loss, [v for v in leaves.values()
                                   if v.requires_grad])
    return float(fc.get_total_flops())
