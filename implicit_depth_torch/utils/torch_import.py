"""Reader of the reference's ``.pth`` checkpoints (counterpart of
``implicit_depth_tpu/utils/torch_import.py``).

The reference saves one dict of per-module state dicts: stage 1
``resnet_model`` / ``pnet_model`` / ``offset_dec`` / ``prob_dec``, stage 2
``pnet_model_refine`` / ``offset_dec_refine``, beside ``optimizer``, the
epoch and metric scalars. The reference is PyTorch too, so convolutions,
Linears and BatchNorm keep their layouts; only the names change:

* ``resnet34_8s.conv1`` / ``bn1`` / ``fc`` -> ``resnet.conv1`` / ``bn1`` /
  ``fc``; ``resnet34_8s.layer{s}.{i}.*`` -> ``resnet.layer{s}_{i}.*``, its
  ``downsample.0`` / ``downsample.1`` -> ``down_conv`` / ``down_bn``;
* the PointNet's ``point_lin1, point_lin2, vox_lin1, point_lin3,
  point_lin4, vox_lin2`` -> ``pnet.l0, l1, v1_mlp, l3, l4, v2_mlp``;
* a decoder's ``linear_1..4`` -> ``mlp.l0..l3``, ``offset_enc`` as it is.

One change of basis: the reference flattens the ROIAlign features
channel-major (``c·S + s``), the port spatial-major (``s·C + c``), so each
decoder's layer-1 weight has its input columns over the block
``[pnet_out, pnet_out + rgb_out·S)`` permuted (:func:`roi_row_permutation`).
A stage-2 file holds no ResNet, so its ``rgb_out`` is an argument (32, as
the JAX converter takes it).

The load is strict: every parameter and BatchNorm buffer of the model comes
from the file, and a tensor missing, left over or of another shape raises
with its name (``num_batches_tracked``, which the port never reads, and
``optimizer`` are skipped). An IMNet offset decoder (no ``offset_enc``) is
told from IEF by its keys; the embedding's width tells whether positional
encoding was on. :func:`import_torch_checkpoint` writes a port checkpoint
directory (``train/checkpoint.py``) that ``checkpoint_path``,
``lidf_ckpt_path``, ``DepthCompleter.from_checkpoint`` and
``tools/complete_depth.py`` load; ``tools/import_torch_ckpt.py`` is its
command line.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from implicit_depth_torch.models.embedder import posenc_dim

Tensors = Dict[str, torch.Tensor]

STAGE1_KEYS = ("resnet_model", "pnet_model", "offset_dec", "prob_dec")
STAGE2_KEYS = ("pnet_model_refine", "offset_dec_refine")
# entries of a reference file that hold no weights of the models
SKIPPED_KEYS = ("optimizer",)
_PNET = (("point_lin1", "l0"), ("point_lin2", "l1"), ("vox_lin1", "v1_mlp"),
         ("point_lin3", "l3"), ("point_lin4", "l4"), ("vox_lin2", "v2_mlp"))
_RESNET = "resnet34_8s."
_BN = ("weight", "bias", "running_mean", "running_var")


def roi_row_permutation(start: int, rgb_c: int, spatial: int) -> np.ndarray:
    """perm with ``ours[start + s·C + c] = ref[start + c·S + s]``: the
    indices, into the reference's layer-1 input, of the port's inputs over
    the ROI block."""
    s = np.arange(spatial)
    c = np.arange(rgb_c)
    return start + (c[None, :] * spatial + s[:, None]).reshape(-1)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth`` on the CPU, through ``torch.load``'s weights-only
    unpickler with numpy's scalar types allowed (the metric scalars of a
    reference file may be numpy values) and nothing else."""
    core = getattr(np, "_core", None) or np.core
    allowed = [core.multiarray.scalar, np.dtype] + sorted(
        {type(np.dtype(t)) for t in "?bhilqBHILQefdg"}, key=str)
    with torch.serialization.safe_globals(allowed):
        return torch.load(path, map_location="cpu", weights_only=True)


def _take(sd: Dict[str, Any], key: str, what: str) -> torch.Tensor:
    if key not in sd:
        raise ValueError(f"{what}: the file has no {key!r}")
    return torch.as_tensor(sd.pop(key)).detach().float()


def _left_over(sd: Dict[str, Any], what: str) -> None:
    extra = sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    if extra:
        raise ValueError(f"{what}: tensors the model has no place for: "
                         f"{extra}")


def _resnet(sd: Dict[str, Any]) -> Tuple[Tensors, Tuple[int, ...]]:
    """The ResNet's tensors under the port's names, and its blocks per
    stage."""
    sd, out, what = dict(sd), {}, "resnet_model"

    def bn(src, dst):
        for k in _BN:
            out[f"{dst}.{k}"] = _take(sd, f"{src}.{k}", what)

    out["resnet.conv1.weight"] = _take(sd, _RESNET + "conv1.weight", what)
    bn(_RESNET + "bn1", "resnet.bn1")
    stages = []
    for s in range(1, 5):
        i = 0
        while f"{_RESNET}layer{s}.{i}.conv1.weight" in sd:
            src, dst = f"{_RESNET}layer{s}.{i}", f"resnet.layer{s}_{i}"
            for conv in ("conv1", "conv2"):
                out[f"{dst}.{conv}.weight"] = _take(sd, f"{src}.{conv}.weight",
                                                    what)
            bn(f"{src}.bn1", f"{dst}.bn1")
            bn(f"{src}.bn2", f"{dst}.bn2")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.down_conv.weight"] = _take(
                    sd, f"{src}.downsample.0.weight", what)
                bn(f"{src}.downsample.1", f"{dst}.down_bn")
            i += 1
        stages.append(i)
    for k in ("weight", "bias"):
        out[f"resnet.fc.{k}"] = _take(sd, f"{_RESNET}fc.{k}", what)
    _left_over(sd, what)
    return out, tuple(stages)


def _pointnet(sd: Dict[str, Any], prefix: str, what: str) -> Tensors:
    sd, out = dict(sd), {}
    for ref, port in _PNET:
        for k in ("weight", "bias"):
            out[f"{prefix}.{port}.{k}"] = _take(sd, f"{ref}.{k}", what)
    _left_over(sd, what)
    return out


def _decoder(sd: Dict[str, Any], prefix: str, what: str,
             roi_block: Tuple[int, int, int]) -> Tensors:
    """An IEF (``offset_enc`` + ``linear_1..4``) or IMNet (``linear_1..4``)
    decoder, its layer-1 ROI input columns permuted."""
    sd, out = dict(sd), {}
    if any(k.startswith("offset_enc.") for k in sd):
        for k in ("weight", "bias"):
            out[f"{prefix}.offset_enc.{k}"] = _take(sd, f"offset_enc.{k}",
                                                    what)
    for i in range(4):
        for k in ("weight", "bias"):
            out[f"{prefix}.mlp.l{i}.{k}"] = _take(sd, f"linear_{i + 1}.{k}",
                                                  what)
    _left_over(sd, what)
    start, rgb_c, spatial = roi_block
    w = out[f"{prefix}.mlp.l0.weight"]
    if w.shape[1] < start + rgb_c * spatial:
        raise ValueError(f"{what}: layer 1 takes {w.shape[1]} inputs, fewer "
                         f"than the ROI block ends at "
                         f"({start} + {rgb_c}·{spatial})")
    w = w.clone()
    w[:, start:start + rgb_c * spatial] = \
        out[f"{prefix}.mlp.l0.weight"][:, roi_row_permutation(start, rgb_c,
                                                              spatial)]
    out[f"{prefix}.mlp.l0.weight"] = w
    return out


def stage_of(ckpt: Dict[str, Any]) -> str:
    """'refine' for a file with the stage-2 PointNet, else 'lidf'."""
    return "refine" if "pnet_model_refine" in ckpt else "lidf"


def _check_entries(ckpt: Dict[str, Any], keys) -> None:
    extra = sorted(k for k, v in ckpt.items() if isinstance(v, dict)
                   and k not in keys and k not in SKIPPED_KEYS)
    if extra:
        raise ValueError(f"entries of the file no model reads: {extra}")


def lidf_state_dict(ckpt: Dict[str, Any], roi_spatial: int = 4
                    ) -> Tuple[Tensors, Dict[str, Any]]:
    """A stage-1 file as the port's ``LIDFModel`` state (without
    ``num_batches_tracked``), and the widths it implies."""
    _check_entries(ckpt, STAGE1_KEYS)
    resnet, stages = _resnet(ckpt["resnet_model"])
    pnet = _pointnet(ckpt["pnet_model"], "pnet", "pnet_model")
    pnet_out = pnet["pnet.v2_mlp.weight"].shape[0]
    rgb_out = resnet["resnet.fc.bias"].shape[0]
    block = (pnet_out, rgb_out, roi_spatial)
    off = _decoder(ckpt["offset_dec"], "offset_dec", "offset_dec", block)
    prob = _decoder(ckpt["prob_dec"], "prob_dec", "prob_dec", block)
    widths = {"rgb_out": rgb_out, "pnet_out": pnet_out,
              "pnet_gf": pnet["pnet.l0.weight"].shape[0],
              "imnet_gf": off["offset_dec.mlp.l0.weight"].shape[0] // 4,
              "offdec_type": ("IEF" if "offset_dec.offset_enc.weight" in off
                              else "IMNET"),
              "resnet_stages": list(stages),
              "embed": prob["prob_dec.mlp.l0.weight"].shape[1]}
    return {**resnet, **pnet, **off, **prob}, widths


def refine_state_dict(ckpt: Dict[str, Any], rgb_out: int = 32,
                      roi_spatial: int = 4) -> Tuple[Tensors, Dict[str, Any]]:
    """A stage-2 file as the port's ``RefineModel`` state, and the widths
    it implies (``rgb_out`` given: the file holds no ResNet)."""
    _check_entries(ckpt, STAGE2_KEYS)
    pnet = _pointnet(ckpt["pnet_model_refine"], "pnet", "pnet_model_refine")
    pnet_out = pnet["pnet.v2_mlp.weight"].shape[0]
    off = _decoder(ckpt["offset_dec_refine"], "offset_dec",
                   "offset_dec_refine", (pnet_out, rgb_out, roi_spatial))
    ief = "offset_dec.offset_enc.weight" in off
    widths = {"rgb_out": rgb_out, "pnet_out": pnet_out,
              "pnet_gf": pnet["pnet.l0.weight"].shape[0],
              "imnet_gf": off["offset_dec.mlp.l0.weight"].shape[0] // 4,
              "offdec_type": "IEF" if ief else "IMNET",
              "embed": off["offset_dec.mlp.l0.weight"].shape[1] - 16 * ief}
    return {**pnet, **off}, widths


def meta_of(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """The file's scalars (python or numpy numbers) as floats, and its
    epoch as an int, as the JAX converter reads them."""
    meta = {k: float(v) for k, v in ckpt.items()
            if isinstance(v, (int, float, np.number)) and k != "epoch"}
    meta["epoch"] = int(ckpt.get("epoch", 0))
    return meta


def load_strict(model: nn.Module, state: Tensors) -> nn.Module:
    """``state`` into ``model``: every parameter and buffer of the model but
    ``num_batches_tracked`` must be there with its shape, and nothing else;
    raises naming each that is not. Returns ``model``."""
    own = model.state_dict()
    want = {k for k in own if not k.endswith("num_batches_tracked")}
    missing, extra = sorted(want - set(state)), sorted(set(state) - want)
    if missing or extra:
        raise ValueError(f"the file does not fit the model: missing "
                         f"{missing}, not in the model {extra}")
    for k in sorted(want):
        if tuple(state[k].shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(state[k].shape)} in the "
                             f"file, {tuple(own[k].shape)} in the model")
    with torch.no_grad():
        for k in want:
            own[k].copy_(state[k])
    return model


def _pos_encode(embed: int, fixed: int, m) -> bool:
    """Whether an embedding of width ``embed`` (``fixed`` of it the voxel
    and ROI features) had positional encoding, at the config's
    ``multires`` / ``multires_views`` (``m``)."""
    for on in (True, False):
        if embed == fixed + m["n_pos"] * posenc_dim(m["multires"],
                                                    enabled=on) \
                + posenc_dim(m["multires_views"], enabled=on):
            return on
    raise ValueError(f"a layer 1 of {embed} inputs ({fixed} voxel and ROI "
                     f"features) fits neither positional encoding at "
                     f"multires {m['multires']} / {m['multires_views']} nor "
                     "none")


def build_from_reference(ckpt: Dict[str, Any], stage: str = "auto",
                         cfg=None, rgb_out: int = 32) -> nn.Module:
    """The port's model of ``stage`` ('lidf', 'refine', or 'auto' from the
    keys) at the widths the file's tensors give (its decoder type, positional
    encoding on or off, the ResNet's blocks; ``cfg`` — the default config if
    None — gives the rest), with every tensor loaded from the file."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_refine,
        build_static,
    )
    from implicit_depth_torch.config import load_config

    cfg = cfg if cfg is not None else load_config()
    stage = stage_of(ckpt) if stage == "auto" else stage
    spatial = cfg.model.roi_out_bbox ** 2
    if stage == "lidf":
        state, w = lidf_state_dict(ckpt, spatial)
        section, n_pos = "model", 2    # posenc(enter), posenc(leave)
    elif stage == "refine":
        state, w = refine_state_dict(ckpt, rgb_out, spatial)
        section, n_pos = "refine", 1   # posenc(prediction)
    else:
        raise ValueError(f"stage {stage!r}: 'lidf', 'refine' or 'auto'")
    sec = cfg[section]
    pe = _pos_encode(w["embed"], w["pnet_out"] + w["rgb_out"] * spatial,
                     {"n_pos": n_pos, "multires": sec.multires,
                      "multires_views": sec.multires_views})
    widths = {k: w[k] for k in ("pnet_out", "pnet_gf", "imnet_gf",
                                "offdec_type")}
    cfg.update_from({section: {**widths, "pos_encode": pe}})
    cfg.update_from({"model": {"rgb_out": w["rgb_out"]}})
    if stage == "lidf":
        cfg.update_from({"model": {"resnet_stages": w["resnet_stages"]}})
    static = build_static(cfg)
    model = build_lidf(cfg, static) if stage == "lidf" \
        else build_refine(cfg, static)
    return load_strict(model, state)


def import_torch_checkpoint(pth_path: str, out_dir: str, stage: str = "auto",
                            rgb_out: int = 32) -> str:
    """Convert a reference ``.pth`` into a port checkpoint directory
    (``latest_network`` of ``train/checkpoint.py``: the model's state, no
    optimizer, the file's epoch and scalars in its metadata). Returns the
    stage imported."""
    from implicit_depth_torch.train.checkpoint import Checkpointer

    ckpt = read_checkpoint(pth_path)
    stage = stage_of(ckpt) if stage == "auto" else stage
    model = build_from_reference(ckpt, stage, rgb_out=rgb_out)
    meta = meta_of(ckpt)
    Checkpointer(out_dir).save(model, epoch=meta["epoch"], meta=meta)
    return stage


def load_reference(model: nn.Module, ckpt: Dict[str, Any],
                   rgb_out: Optional[int] = None) -> nn.Module:
    """A reference file's stage into an existing ``LIDFModel`` (stage 1) or
    ``RefineModel`` (stage 2), strictly (:func:`load_strict`): an IMNet
    file into an IEF model raises, as does any width that does not fit."""
    from implicit_depth_torch.models.lidf import LIDFModel

    spatial = model.static.roi_out_bbox ** 2
    if isinstance(model, LIDFModel):
        state, _ = lidf_state_dict(ckpt, spatial)
    else:
        roi = model.dims["c_rc"] - model.dims["c_dir"]
        state, _ = refine_state_dict(ckpt, rgb_out or roi // spatial, spatial)
    return load_strict(model, state)
