"""Weight bridge: the JAX package's flax variable trees -> the port's modules.

The trees come with numpy leaves (convert with ``jax.device_get`` or
``np.asarray`` first); nothing here imports JAX. Conversions:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in); ``bias`` as is;
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``.

The other way, :func:`resnet_batch_stats` gives the ResNet's running
statistics as a flax ``batch_stats`` tree, and :func:`lidf_grads_from_jax`
and :func:`refine_grads_from_jax` lay a JAX gradient tree (shaped like
``params``) onto the port's parameter names through the same transposes,
so that gradients compare parameter by parameter.

Names mapped: ``resnet/conv1``, ``resnet/bn1``,
``resnet/layer{s}_{i}/{conv1,bn1,conv2,bn2,down_conv,down_bn}``,
``resnet/fc``; ``pnet/Dense_0..5``; ``offset_dec/{Dense_0, _MLP4_0/Dense_0..3}``;
``prob_dec/_MLP4_0/Dense_0..3``. The ROI features keep the JAX package's
spatial-major layout, so decoder weights need transposes only.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from implicit_depth_torch.models.imnet import IEF, IMNet
from implicit_depth_torch.models.lidf import LIDFModel
from implicit_depth_torch.models.pointnet import PointNet2Stage
from implicit_depth_torch.models.refine import RefineModel
from implicit_depth_torch.models.resnet import ResNet34_8s

Tree = Dict[str, Any]

_PNET = ("l0", "l1", "v1_mlp", "l3", "l4", "v2_mlp")  # Dense_0..Dense_5


def _copy(dst: torch.Tensor, src, what: str) -> None:
    src = torch.from_numpy(np.array(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _dense(lin: nn.Linear, p: Tree, what: str) -> None:
    _copy(lin.weight, np.asarray(p["kernel"]).T, f"{what}/kernel")
    _copy(lin.bias, p["bias"], f"{what}/bias")


def _conv(conv: nn.Conv2d, p: Tree, what: str) -> None:
    _copy(conv.weight, np.asarray(p["kernel"]).transpose(3, 2, 0, 1),
          f"{what}/kernel")
    if conv.bias is not None:
        _copy(conv.bias, p["bias"], f"{what}/bias")


def _bn(bn: nn.BatchNorm2d, p: Tree, stats: Tree, what: str) -> None:
    """scale/bias, and the running statistics when ``stats`` has them."""
    _copy(bn.weight, p["scale"], f"{what}/scale")
    _copy(bn.bias, p["bias"], f"{what}/bias")
    if stats:
        _copy(bn.running_mean, stats["mean"], f"{what}/mean")
        _copy(bn.running_var, stats["var"], f"{what}/var")


def _resnet_parts(m: ResNet34_8s) -> Iterator[Tuple[str, nn.Module]]:
    yield "conv1", m.conv1
    yield "bn1", m.bn1
    for name in m.block_names:
        blk = getattr(m, name)
        for part in ("conv1", "bn1", "conv2", "bn2", "down_conv", "down_bn"):
            mod = getattr(blk, part)
            if mod is not None:
                yield f"{name}/{part}", mod
    yield "fc", m.fc


def load_resnet(m: ResNet34_8s, params: Tree, stats: Tree) -> None:
    for path, mod in _resnet_parts(m):
        p, s = params, stats
        for key in path.split("/"):
            p = p[key]
            s = s.get(key, {}) if isinstance(s, dict) else {}
        if isinstance(mod, nn.BatchNorm2d):
            _bn(mod, p, s, f"resnet/{path}")
        else:
            _conv(mod, p, f"resnet/{path}")


def resnet_batch_stats(m: ResNet34_8s) -> Tree:
    """The running statistics as the flax tree under ``batch_stats/resnet``
    (numpy leaves)."""
    tree: Tree = {}
    for path, mod in _resnet_parts(m):
        if isinstance(mod, nn.BatchNorm2d):
            node = tree
            for key in path.split("/"):
                node = node.setdefault(key, {})
            node["mean"] = mod.running_mean.detach().cpu().numpy()
            node["var"] = mod.running_var.detach().cpu().numpy()
    return tree


def load_pointnet(m: PointNet2Stage, params: Tree, what: str = "pnet") -> None:
    for i, name in enumerate(_PNET):
        _dense(getattr(m, name), params[f"Dense_{i}"], f"{what}/Dense_{i}")


def load_mlp_decoder(m, params: Tree, what: str) -> None:
    """IEF (offset encoder ``Dense_0`` + ``_MLP4_0``) or IMNet (``_MLP4_0``)."""
    if isinstance(m, IEF):
        _dense(m.offset_enc, params["Dense_0"], f"{what}/Dense_0")
    elif not isinstance(m, IMNet):
        raise TypeError(f"{what}: not an IEF/IMNet decoder")
    for i, lin in enumerate(m.mlp.layers()):
        _dense(lin, params["_MLP4_0"][f"Dense_{i}"], f"{what}/_MLP4_0/Dense_{i}")


def lidf_from_jax(variables: Tree, model: LIDFModel) -> LIDFModel:
    """Load a JAX ``LIDFModel``'s variables ({"params", "batch_stats"}) into
    ``model``; returns it."""
    params = variables["params"]
    load_resnet(model.resnet, params["resnet"],
                variables.get("batch_stats", {}).get("resnet", {}))
    load_pointnet(model.pnet, params["pnet"])
    load_mlp_decoder(model.offset_dec, params["offset_dec"], "offset_dec")
    load_mlp_decoder(model.prob_dec, params["prob_dec"], "prob_dec")
    return model


def refine_from_jax(params: Tree, model: RefineModel) -> RefineModel:
    """Load a JAX ``RefineModel``'s params (the tree under "params", or the
    variables dict holding it) into ``model``; returns it."""
    params = params.get("params", params)
    load_pointnet(model.pnet, params["pnet"])
    load_mlp_decoder(model.offset_dec, params["offset_dec"], "offset_dec")
    return model


def lidf_grads_from_jax(grads: Tree, model: LIDFModel) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of ``LIDFModel`` params (numpy leaves) in the
    port's layout: {name of ``model.named_parameters()``: tensor}."""
    m = lidf_from_jax({"params": grads}, copy.deepcopy(model).cpu())
    return {name: p.detach() for name, p in m.named_parameters()}


def refine_grads_from_jax(grads: Tree,
                          model: RefineModel) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of ``RefineModel`` params (numpy leaves) in the
    port's layout: {name of ``model.named_parameters()``: tensor}."""
    m = refine_from_jax(grads, copy.deepcopy(model).cpu())
    return {name: p.detach() for name, p in m.named_parameters()}
