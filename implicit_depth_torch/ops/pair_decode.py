"""Per-pair implicit decode of the ``global`` and dense stage-1 modes (K6).

Counterpart of ``implicit_depth_tpu/ops/pallas_decode.py`` (``fused_pair_decode``,
``xla_pair_decode``, ``_decode_tile``). Each of P pair rows is decoded from
its 385-d embedding [voxel row | roi | pe(enter) | pe(leave) | dir_e] by the
IEF offset decoder (2 iterations of 256-128-64-1 over the hoisted layer 1,
the 1 -> 16 offset encoder folded into a rank-1 update) and the IMNet
termination-probability decoder. A row names its voxel row by cell in the
(B·G³, Cv) voxel table and its ray by index in the per-ray [roi | dir_e]
rows, so neither the gathered (P, 385) embedding nor a broadcast of the
per-ray features is ever built for the kernel.

Where K6's numerics differ from K1's (``ops/ray_decode.py``):
* the probability decoder adds its biases 1-3 in f32, unrounded (``_mlp4``);
  the IEF's biases 2 and 3 are rounded to the compute dtype, as in K1;
* the positional encoding computes cos directly (no sin(x + π/2) phase),
  laid out [x | sin(3) cos(3) per frequency] per position, and the raw x is
  rounded to the compute dtype with the rest of the embedding;
* layer 1 is one product over the whole embedding.

The wrapper :func:`pair_decode` runs :func:`pair_decode_plain` for CPU
tensors and launches the CUDA kernel (``csrc/pair_decode.cu``) for CUDA
tensors, counting launches in ``pair_decode.launches``. The kernel has no
backward, as the JAX kernel has no VJP.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from implicit_depth_torch.models.embedder import posenc_dim
from implicit_depth_torch.ops import cuda
from implicit_depth_torch.ops.ray_decode import (
    _PAD,
    _act,
    _check_cuda,
    _dot,
    _ief_loop,
    _mlp_tail,
    _pad_rows,
    _q,
    _rank1,
    _round_up,
    _squash,
)

_MATRICES = ("w1", "off_w2", "off_w3", "off_w4", "prob_w2", "prob_w3",
             "prob_w4")
ROUNDED_BIASES = ("off_b2", "off_b3")  # prob_b1..b3 add unrounded (_mlp4)
_K6_WEIGHTS = ("w1", "b1", "a_vec", "c_vec",
               "off_w2", "off_b2", "off_w3", "off_b3", "off_w4", "off_b4",
               "prob_w2", "prob_b2", "prob_w3", "prob_b3", "prob_w4", "prob_b4")


def posenc_rows(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(rows, 3) f32 -> (rows, 3·(1 + 2·multires)) [x | sin(x·2^j) (3) |
    cos(x·2^j) (3) per frequency j], cos computed directly (``_posenc``)."""
    parts = [x]
    for j in range(multires):
        arg = x * (2.0 ** j)
        parts += [torch.sin(arg), torch.cos(arg)]
    return torch.cat(parts, -1)


def pair_decode_weights(weights: Dict[str, torch.Tensor], c_vox: int,
                        c_roi: int, c_dir: int, multires: int,
                        dtype) -> Dict[str, torch.Tensor]:
    """The decoder weights (``models/lidf.py::decoder_weights`` layout) as
    K6's operands, all in f32: w1 (KP, 2·4g) rows [embed | 0-pad], columns
    [off | prob]; b1 (2·4g,); a_vec, c_vec (4g,) of the offset encoder
    folded with ``dtype`` operands; each decoder's layers 2-4. Only slicing,
    concatenation and the rank-1 fold, so autograd lays gradients taken at
    these operands back onto the parameters."""
    c_embed = c_vox + c_roi + 2 * posenc_dim(multires) + c_dir
    a_vec, c_vec = _rank1(weights["off_enc_w"], weights["off_enc_b"],
                          weights["off_w1"][c_embed:], dtype)
    w = {"w1": _pad_rows(torch.cat([weights["off_w1"][:c_embed],
                                    weights["prob_w1"]], 1),
                         _round_up(c_embed, _PAD)).float(),
         "b1": torch.cat([weights["off_b1"], weights["prob_b1"]]).float(),
         "a_vec": a_vec, "c_vec": c_vec}
    for p in ("off", "prob"):
        for n in ("w2", "b2", "w3", "b3"):
            w[f"{p}_{n}"] = weights[f"{p}_{n}"].float()
        w[f"{p}_w4"] = weights[f"{p}_w4"].reshape(-1).float()
        w[f"{p}_b4"] = weights[f"{p}_b4"].reshape(1).float()
    w["dims"] = (c_vox, c_roi, c_dir, multires)
    return w


def round_pair_biases(w: Dict[str, torch.Tensor],
                      dtype) -> Dict[str, torch.Tensor]:
    """``w`` with the IEF's biases 2 and 3 rounded to ``dtype`` (held in
    f32; a straight-through step under autograd)."""
    return {**w, **{k: _q(w[k], dtype) for k in ROUNDED_BIASES}}


def prep_pair_decode_weights(weights: Dict[str, torch.Tensor], c_vox: int,
                             c_roi: int, c_dir: int, multires: int,
                             dtype) -> Dict[str, torch.Tensor]:
    """The kernel operands: :func:`pair_decode_weights` with the matrices
    in ``dtype`` and the IEF's biases 2 and 3 rounded to it."""
    w = round_pair_biases(pair_decode_weights(weights, c_vox, c_roi, c_dir,
                                              multires, dtype), dtype)
    for k in _MATRICES:
        w[k] = w[k].to(dtype).contiguous()
    return w


def _dense_slots(p: int, n_rays: int) -> int:
    """The rows per ray of the dense layout (``rays=None``: each ray's
    P / N consecutive rows)."""
    if n_rays == 0 or p % n_rays:
        raise ValueError("pair_decode: without rays, P must be a multiple "
                         "of the number of rays")
    return p // n_rays


def pair_decode_plain(vox_table, cells, pos, ray_feat, w, rays=None, *,
                      n_iter=2, init_offset=0.001, use_sigmoid=False,
                      dtype=None):
    """vox_table (S, Cv); cells (P,) row ids into it; pos (P, 6) f32 [enter
    | leave]; ray_feat (N, c_roi + c_dir) [roi | dir_e]; rays (P,) ray ids
    into it (None: ray = row // (P / N)) -> (offset, prob_logit), each (P,)
    f32 after the squash. ``dtype``: the compute dtype (default: that of
    ``w["w1"]``, which may then hold f32 values)."""
    dtype = dtype or w["w1"].dtype
    c_vox, c_roi, c_dir, multires = w["dims"]
    g4 = w["b1"].shape[0] // 2
    if rays is None:
        rays = torch.arange(cells.shape[0], device=cells.device) // \
            _dense_slots(cells.shape[0], ray_feat.shape[0])
    rf = ray_feat[rays.long()].float()
    pos = pos.float()
    x = _q(torch.cat([vox_table[cells.long()].float(), rf[:, :c_roi],
                      posenc_rows(pos[:, :3], multires),
                      posenc_rows(pos[:, 3:], multires), rf[:, c_roi:]], 1),
           dtype)
    z = _dot(x, w["w1"][:x.shape[1]], dtype) + w["b1"]
    offset = _ief_loop(z[:, :g4], w, "off_", n_iter, init_offset, dtype)
    logit = _mlp_tail(_act(z[:, g4:]), w, "prob_", dtype) + w["prob_b4"]
    return _squash(offset, use_sigmoid), _squash(logit, use_sigmoid)


def _pair_decode_cuda(vox_table, cells, pos, ray_feat, w, rays, n_iter,
                      init_offset, use_sigmoid):
    dtype = w["w1"].dtype
    p = cells.shape[0]
    c_vox, c_roi, c_dir, multires = w["dims"]
    c_ray = c_roi + c_dir
    _check_cuda("pair_decode", [vox_table, cells, pos, ray_feat,
                                *(w[k] for k in _K6_WEIGHTS),
                                *([] if rays is None else [rays])], dtype)
    if w["w1"].shape[1] != 512 or w["off_w3"].shape != (128, 64):
        raise ValueError("pair_decode kernel takes layer widths 256-128-64-1")
    if vox_table.shape[1] != c_vox or ray_feat.shape[1] != c_ray \
            or pos.shape != (p, 6) or cells.dim() != 1 \
            or (rays is not None and rays.shape != (p,)):
        raise ValueError("pair_decode: operand shapes do not match the weights")
    if rays is None:
        slots = _dense_slots(p, ray_feat.shape[0])
    else:
        rays, slots = rays.to(torch.int32).contiguous(), 0
    vox_table, ray_feat = (t.to(dtype).contiguous() for t in (vox_table,
                                                             ray_feat))
    cells, pos = cells.to(torch.int32).contiguous(), pos.float().contiguous()
    off = torch.empty((p,), dtype=torch.float32, device=cells.device)
    logit = torch.empty_like(off)
    ptrs = cuda.ptr_array([vox_table, cells, rays, pos, ray_feat,
                           *(w[k] for k in _K6_WEIGHTS), off, logit])
    fn = cuda.bind("pair_decode", "idt_pair_decode", cuda.PTR,
                   *[cuda.I64] * 10, cuda.F32)
    cuda.check(fn(ptrs, p, c_vox, c_roi, c_dir, multires, w["w1"].shape[0],
                  slots, n_iter, int(dtype == torch.bfloat16),
                  int(use_sigmoid), init_offset,
                  cuda.stream_ptr(cells.device)), "pair_decode")
    return off, logit


def pair_decode(vox_table, cells, pos, ray_feat, w,
                rays: Optional[torch.Tensor] = None, *, n_iter=2,
                init_offset=0.001, use_sigmoid=False):
    """Stage-1 per-pair decode (see :func:`pair_decode_plain`); kernel K6 on
    CUDA. ``w``: :func:`prep_pair_decode_weights`."""
    if cells.device.type == "cpu":
        return pair_decode_plain(vox_table, cells, pos, ray_feat, w, rays,
                                 n_iter=n_iter, init_offset=init_offset,
                                 use_sigmoid=use_sigmoid)
    out = _pair_decode_cuda(vox_table, cells, pos, ray_feat, w, rays, n_iter,
                            init_offset, use_sigmoid)
    pair_decode.launches += 1
    return out


pair_decode.launches = 0
