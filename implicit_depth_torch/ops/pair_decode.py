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
* layer 1 is one product over the whole embedding, whose columns (and
  w1's rows) the port lays out as the kernel stages them
  (:func:`pair_layout`): [vox | roi | dir_e | 0 | pe(enter) | pe(leave) |
  0], a reordering of layer 1's f32 sum.

Both versions take an optional row count ``n_rows`` (a 0-d int32 tensor on
the operands' device): rows at or past it give exactly 0 in both outputs,
and the kernel decodes none of them. The ``global`` mode passes its valid
prefix, counted on the device, so that the launch is sized with no host
sync.

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
    _aligned,
    _check_cuda,
    _check_plan,
    _dot,
    _ief_loop,
    _mlp_tail,
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
# the columns past the ray row (positional encoding and padding) the bf16
# kernel stages in each row: 5 a lane of a warp
MAX_PE_COLS = 160
_RAY_ALIGN = 8  # a ray row padded to 16 bytes of bf16 (cp.async pieces)


def pair_layout(c_vox: int, c_roi: int, c_dir: int, multires: int) -> dict:
    """K6's layer-1 input layout, the columns of a row's X (and w1's rows):
    [vox (c_vox) | ray row (c_rp: roi | dir_e | 0) | pe(enter) | pe(leave)
    (2·c_pe from o_pe) | 0 to kp]. The ray row is padded to a 16-byte
    multiple of bf16 so that the kernel gathers it, like the voxel row, by
    cp.async in 16-byte pieces; kp is a multiple of the 16-deep mma step."""
    c_rp = _round_up(c_roi + c_dir, _RAY_ALIGN)
    c_pe = posenc_dim(multires)
    o_pe = c_vox + c_rp
    return {"c_rp": c_rp, "c_pe": c_pe, "o_pe": o_pe,
            "kp": _round_up(o_pe + 2 * c_pe, _PAD)}


def _layer1_rows(w: torch.Tensor, c_vox: int, c_roi: int, c_dir: int,
                 multires: int) -> torch.Tensor:
    """Rows of a layer-1 matrix in embedding order [vox | roi | pe(enter)
    | pe(leave) | dir_e] laid out as :func:`pair_layout` (zero rows at the
    padding)."""
    lay = pair_layout(c_vox, c_roi, c_dir, multires)
    o_pe = c_vox + c_roi
    o_dir = o_pe + 2 * lay["c_pe"]
    zeros = lambda k: w.new_zeros((k, *w.shape[1:]))  # noqa: E731
    return torch.cat([w[:o_pe], w[o_dir:o_dir + c_dir],
                      zeros(lay["c_rp"] - c_roi - c_dir), w[o_pe:o_dir],
                      zeros(lay["kp"] - lay["o_pe"] - 2 * lay["c_pe"])], 0)


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
    K6's operands, all in f32: w1 (kp, 2·4g) rows in :func:`pair_layout`'s
    order, columns [off | prob]; b1 (2·4g,); a_vec, c_vec (4g,) of the
    offset encoder folded with ``dtype`` operands; each decoder's layers
    2-4. Only slicing, concatenation and the rank-1 fold, so autograd lays
    gradients taken at these operands back onto the parameters."""
    c_embed = c_vox + c_roi + 2 * posenc_dim(multires) + c_dir
    a_vec, c_vec = _rank1(weights["off_enc_w"], weights["off_enc_b"],
                          weights["off_w1"][c_embed:], dtype)
    w = {"w1": _layer1_rows(torch.cat([weights["off_w1"][:c_embed],
                                       weights["prob_w1"]], 1),
                            c_vox, c_roi, c_dir, multires).float(),
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


def _ray_rows(ray_feat: torch.Tensor, c_rp: int) -> torch.Tensor:
    """The per-ray [roi | dir_e] rows padded with zero columns to c_rp."""
    return torch.nn.functional.pad(ray_feat, (0, c_rp - ray_feat.shape[1]))


def _mask_rows(v: torch.Tensor, n_rows) -> torch.Tensor:
    """``v`` (P,) with exact zeros at rows >= ``n_rows`` (None: unmasked)."""
    if n_rows is None:
        return v
    keep = torch.arange(v.shape[0], device=v.device) < n_rows
    return torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device))


def layer1(vox_table, cells, pos, ray_feat, w, rays, dtype):
    """(P, 2·4g) f32 layer-1 pre-activations [off | prob] of both decoders,
    biases added, from X in :func:`pair_layout`'s order."""
    lay = pair_layout(*w["dims"])
    multires = w["dims"][3]
    if rays is None:
        rays = torch.arange(cells.shape[0], device=cells.device) // \
            _dense_slots(cells.shape[0], ray_feat.shape[0])
    pos = pos.float()
    x = _q(torch.cat([vox_table[cells.long()].float(),
                      _ray_rows(ray_feat[rays.long()].float(), lay["c_rp"]),
                      posenc_rows(pos[:, :3], multires),
                      posenc_rows(pos[:, 3:], multires)], 1), dtype)
    return _dot(x, w["w1"][:x.shape[1]], dtype) + w["b1"]


def pair_decode_plain(vox_table, cells, pos, ray_feat, w, rays=None, *,
                      n_rows=None, n_iter=2, init_offset=0.001,
                      use_sigmoid=False, dtype=None):
    """vox_table (S, Cv); cells (P,) row ids into it; pos (P, 6) f32 [enter
    | leave]; ray_feat (N, c_roi + c_dir) [roi | dir_e]; rays (P,) ray ids
    into it (None: ray = row // (P / N)) -> (offset, prob_logit), each (P,)
    f32 after the squash, exactly 0 at rows >= ``n_rows`` (a 0-d integer
    tensor; None: every row). ``dtype``: the compute dtype (default: that of
    ``w["w1"]``, which may then hold f32 values)."""
    dtype = dtype or w["w1"].dtype
    g4 = w["b1"].shape[0] // 2
    z = layer1(vox_table, cells, pos, ray_feat, w, rays, dtype)
    offset = _ief_loop(z[:, :g4], w, "off_", n_iter, init_offset, dtype)
    logit = _mlp_tail(_act(z[:, g4:]), w, "prob_", dtype) + w["prob_b4"]
    return (_mask_rows(_squash(offset, use_sigmoid), n_rows),
            _mask_rows(_squash(logit, use_sigmoid), n_rows))


def _pair_decode_cuda(vox_table, cells, pos, ray_feat, w, rays, n_rows,
                      n_iter, init_offset, use_sigmoid):
    dtype = w["w1"].dtype
    p = cells.shape[0]
    c_vox, c_roi, c_dir, multires = w["dims"]
    lay = pair_layout(c_vox, c_roi, c_dir, multires)
    kp, is_bf16 = w["w1"].shape[0], dtype == torch.bfloat16
    _check_cuda("pair_decode", [vox_table, cells, pos, ray_feat,
                                *(w[k] for k in _K6_WEIGHTS),
                                *(t for t in (rays, n_rows) if t is not None)],
                dtype)
    if w["w1"].shape[1] != 512 or w["off_w3"].shape != (128, 64):
        raise ValueError("pair_decode kernel takes layer widths 256-128-64-1")
    if vox_table.shape[1] != c_vox or ray_feat.shape[1] != c_roi + c_dir \
            or pos.shape != (p, 6) or cells.dim() != 1 or kp != lay["kp"] \
            or (rays is not None and rays.shape != (p,)) \
            or (n_rows is not None and n_rows.dim() != 0):
        raise ValueError("pair_decode: operand shapes do not match the weights")
    if is_bf16 and (c_vox % 8 or kp - lay["o_pe"] > MAX_PE_COLS):
        raise ValueError(f"pair_decode kernel takes c_vox a multiple of 8 and "
                         f"at most {MAX_PE_COLS} columns past the ray row in "
                         f"bf16 (got c_vox={c_vox}, {kp - lay['o_pe']})")
    _check_plan("pair_decode", "K6", kp, 0, n_iter, is_bf16, p)
    if rays is None:
        slots = _dense_slots(p, ray_feat.shape[0])
    else:
        rays, slots = rays.to(torch.int32).contiguous(), 0
    if n_rows is not None:
        n_rows = n_rows.to(torch.int32).contiguous()
    vox_table = _aligned(vox_table.to(dtype).contiguous())
    ray_feat = _aligned(_ray_rows(ray_feat.to(dtype), lay["c_rp"]).contiguous())
    cells, pos = cells.to(torch.int32).contiguous(), pos.float().contiguous()
    off = torch.empty((p,), dtype=torch.float32, device=cells.device)
    logit = torch.empty_like(off)
    ptrs = cuda.ptr_array([vox_table, cells, rays, pos, ray_feat,
                           *(w[k] for k in _K6_WEIGHTS), n_rows, off, logit])
    fn = cuda.bind("pair_decode", "idt_pair_decode", cuda.PTR,
                   *[cuda.I64] * 9, cuda.F32)
    cuda.check(fn(ptrs, p, c_vox, lay["c_rp"], multires, kp, slots, n_iter,
                  int(is_bf16), int(use_sigmoid), init_offset,
                  cuda.stream_ptr(cells.device)), "pair_decode")
    return off, logit


def pair_decode(vox_table, cells, pos, ray_feat, w,
                rays: Optional[torch.Tensor] = None, *,
                n_rows: Optional[torch.Tensor] = None, n_iter=2,
                init_offset=0.001, use_sigmoid=False):
    """Stage-1 per-pair decode (see :func:`pair_decode_plain`); kernel K6 on
    CUDA, which decodes only the rows below ``n_rows``. ``w``:
    :func:`prep_pair_decode_weights`."""
    if cells.device.type == "cpu":
        return pair_decode_plain(vox_table, cells, pos, ray_feat, w, rays,
                                 n_rows=n_rows, n_iter=n_iter,
                                 init_offset=init_offset,
                                 use_sigmoid=use_sigmoid)
    out = _pair_decode_cuda(vox_table, cells, pos, ray_feat, w, rays, n_rows,
                            n_iter, init_offset, use_sigmoid)
    pair_decode.launches += 1
    return out


pair_decode.launches = 0
