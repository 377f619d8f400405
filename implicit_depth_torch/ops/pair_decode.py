"""Per-pair implicit decode of the ``global`` and dense stage-1 modes (K6).

Counterpart of ``implicit_depth_tpu/ops/pallas_decode.py`` (``fused_pair_decode``,
``xla_pair_decode``, ``_decode_tile``). Each of P pair rows is decoded from
its 385-d embedding [voxel row | roi | pe(enter) | pe(leave) | dir_e] by the
IEF offset decoder (2 iterations of 4g-2g-g-1 over the hoisted layer 1,
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
backward, as the JAX kernel has no VJP: the training decode
:func:`pair_decode_train` runs K6 forward and, in its backward
(:class:`PairDecodeTrain`), takes autograd of :func:`pair_decode_plain`
recomputed from the same inputs, by chunks of :data:`TRAIN_CHUNK_ROWS`
rows, as the JAX package trains these modes through autograd of
``xla_pair_decode``.

Spans (``utils/profiling.py``): ``pair_decode.forward`` around the training
forward's K6 launch, ``pair_decode.backward`` around the recompute, and
``sync.pair_rows`` around the backward's one host wait. Counters of the
backward, as function attributes of :func:`pair_decode_bwd_chunked`, read
from the rows that wait brought to the host: ``rows`` (rows recomputed)
and ``chunks``; the gathered rows' gradients go back through
``ops/segment.py::segment_sum_``, which counts its own launches and rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from implicit_depth_torch.ops import cuda, segment
from implicit_depth_torch.ops.decode_common import (
    K_GRANULE,
    OperandFormat,
    act,
    aligned,
    cast_operands,
    check_cuda,
    check_plan,
    dot,
    ief_loop,
    mlp_tail,
    operands_gf,
    pad_columns,
    pad_operands,
    posenc_dim,
    round_biases,
    round_up,
    rounded,
    rows_operand,
    split_operands,
    squash,
)
from implicit_depth_torch.utils import profiling

# the columns past the ray row (positional encoding and padding) the bf16
# kernel stages in each row: 5 a lane of a warp
MAX_PE_COLS = 160
_RAY_ALIGN = 8  # a ray row padded to 16 bytes of bf16 (cp.async pieces)
# rows of one recompute in the training backward (read at call time). Under
# autograd a row of the plain decode keeps ~7-13 KB of activations: the
# dense mode's 12.8 M rows at batch 32 in one piece would need 85-170 GB
TRAIN_CHUNK_ROWS = 1 << 17


def pair_layout(c_vox: int, c_roi: int, c_dir: int, multires: int) -> dict:
    """K6's layer-1 input layout, the columns of a row's X (and w1's rows):
    [vox (c_vox) | ray row (c_rp: roi | dir_e | 0) | pe(enter) | pe(leave)
    (2·c_pe from o_pe) | 0 to kp]. The ray row is padded to a 16-byte
    multiple of bf16 so that the kernel gathers it, like the voxel row, by
    cp.async in 16-byte pieces; kp is a multiple of the 16-deep mma step."""
    c_rp = round_up(c_roi + c_dir, _RAY_ALIGN)
    c_pe = posenc_dim(multires)
    o_pe = c_vox + c_rp
    return {"c_rp": c_rp, "c_pe": c_pe, "o_pe": o_pe,
            "kp": round_up(o_pe + 2 * c_pe, K_GRANULE)}


FORMAT = OperandFormat(
    operands=("w1", "b1", "a_vec", "c_vec",
              "off_w2", "off_b2", "off_w3", "off_b3", "off_w4", "off_b4",
              "prob_w2", "prob_b2", "prob_w3", "prob_b3", "prob_w4",
              "prob_b4"),
    layer1=("w1",), prefixes=("off_", "prob_"),
    # prob_b1..b3 add unrounded (_mlp4)
    rounded=("off_b2", "off_b3"), layout=pair_layout)


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
    K6's operands (``split_operands``), all in f32: w1 (kp, 2·4g) rows in
    :func:`pair_layout`'s order, columns [off | prob]."""
    return split_operands(
        weights, FORMAT, c_vox + c_roi + 2 * posenc_dim(multires) + c_dir,
        (c_vox, c_roi, c_dir, multires),
        lambda w1: (_layer1_rows(w1, c_vox, c_roi, c_dir, multires),), dtype)


def prep_pair_decode_weights(weights: Dict[str, torch.Tensor], c_vox: int,
                             c_roi: int, c_dir: int, multires: int,
                             dtype) -> Dict[str, torch.Tensor]:
    """The serving operands: :func:`pair_decode_weights` at the kernel's
    widths (``pad_operands``), cast as the kernel takes them
    (``cast_operands``)."""
    return cast_operands(pad_operands(pair_decode_weights(
        weights, c_vox, c_roi, c_dir, multires, dtype), FORMAT), FORMAT,
        dtype)


def _dense_slots(p: int, n_rays: int) -> int:
    """The rows per ray of the dense layout (``rays=None``: each ray's
    P / N consecutive rows)."""
    if n_rays == 0 or p % n_rays:
        raise ValueError("pair_decode: without rays, P must be a multiple "
                         "of the number of rays")
    return p // n_rays


def _mask_rows(v: torch.Tensor, n_rows) -> torch.Tensor:
    """``v`` (P,) with exact zeros at rows >= ``n_rows`` (None: unmasked)."""
    if n_rows is None:
        return v
    keep = torch.arange(v.shape[0], device=v.device) < n_rows
    return torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _gather_rows(vox_table, cells, ray_feat, rays):
    """Each pair row's voxel row and ray row (``rays`` None: the dense
    layout)."""
    if rays is None:
        rays = torch.arange(cells.shape[0], device=cells.device) // \
            _dense_slots(cells.shape[0], ray_feat.shape[0])
    return vox_table[cells.long()], ray_feat[rays.long()]


def _layer1_of(vox_rows, pos, ray_rows, w, dtype):
    lay = pair_layout(*w["dims"])
    multires = w["dims"][3]
    pos = pos.float()
    x = rounded(torch.cat([vox_rows.float(),
                           pad_columns(ray_rows.float(), lay["c_rp"]),
                           posenc_rows(pos[:, :3], multires),
                           posenc_rows(pos[:, 3:], multires)], 1), dtype)
    return dot(x, w["w1"][:x.shape[1]], dtype) + w["b1"]


def layer1(vox_table, cells, pos, ray_feat, w, rays, dtype):
    """(P, 2·4g) f32 layer-1 pre-activations [off | prob] of both decoders,
    biases added, from X in :func:`pair_layout`'s order."""
    vox_rows, ray_rows = _gather_rows(vox_table, cells, ray_feat, rays)
    return _layer1_of(vox_rows, pos, ray_rows, w, dtype)


def decode_rows(vox_rows, pos, ray_rows, w, n_rows, n_iter, init_offset,
                use_sigmoid, dtype):
    """:func:`pair_decode_plain` of rows whose voxel and ray rows are
    gathered already."""
    g4 = w["b1"].shape[0] // 2
    z = _layer1_of(vox_rows, pos, ray_rows, w, dtype)
    offset = ief_loop(z[:, :g4], w, "off_", n_iter, init_offset, dtype)
    logit = mlp_tail(act(z[:, g4:]), w, "prob_", dtype) + w["prob_b4"]
    return (_mask_rows(squash(offset, use_sigmoid), n_rows),
            _mask_rows(squash(logit, use_sigmoid), n_rows))


def pair_decode_plain(vox_table, cells, pos, ray_feat, w, rays=None, *,
                      n_rows=None, n_iter=2, init_offset=0.001,
                      use_sigmoid=False, dtype=None):
    """vox_table (S, Cv); cells (P,) row ids into it; pos (P, 6) f32 [enter
    | leave]; ray_feat (N, c_roi + c_dir) [roi | dir_e]; rays (P,) ray ids
    into it (None: ray = row // (P / N)) -> (offset, prob_logit), each (P,)
    f32 after the squash, exactly 0 at rows >= ``n_rows`` (a 0-d integer
    tensor; None: every row). ``dtype``: the compute dtype (default: that of
    ``w["w1"]``, which may then hold f32 values)."""
    vox_rows, ray_rows = _gather_rows(vox_table, cells, ray_feat, rays)
    return decode_rows(vox_rows, pos, ray_rows, w, n_rows, n_iter,
                       init_offset, use_sigmoid, dtype or w["w1"].dtype)


def _pair_decode_cuda(vox_table, cells, pos, ray_feat, w, rays, n_rows,
                      n_iter, init_offset, use_sigmoid):
    dtype = w["w1"].dtype
    p = cells.shape[0]
    c_vox, c_roi, c_dir, multires = w["dims"]
    lay = pair_layout(c_vox, c_roi, c_dir, multires)
    kp, is_bf16 = w["w1"].shape[0], dtype == torch.bfloat16
    check_cuda("pair_decode", [vox_table, cells, pos, ray_feat,
                               *(w[k] for k in FORMAT.operands),
                               *(t for t in (rays, n_rows) if t is not None)],
               dtype)
    g = operands_gf("pair_decode", w, FORMAT)
    if vox_table.shape[1] != c_vox or ray_feat.shape[1] != c_roi + c_dir \
            or pos.shape != (p, 6) or cells.dim() != 1 or kp != lay["kp"] \
            or (rays is not None and rays.shape != (p,)) \
            or (n_rows is not None and n_rows.dim() != 0):
        raise ValueError("pair_decode: operand shapes do not match the weights")
    if is_bf16 and (c_vox % 8 or kp - lay["o_pe"] > MAX_PE_COLS):
        raise ValueError(f"pair_decode kernel takes c_vox a multiple of 8 and "
                         f"at most {MAX_PE_COLS} columns past the ray row in "
                         f"bf16 (got c_vox={c_vox}, {kp - lay['o_pe']}; "
                         "pad_operands pads c_vox)")
    check_plan("pair_decode", "K6", kp, 0, n_iter, is_bf16, p, g)
    if rays is None:
        slots = _dense_slots(p, ray_feat.shape[0])
    else:
        rays, slots = rays.to(torch.int32).contiguous(), 0
    if n_rows is not None:
        n_rows = n_rows.to(torch.int32).contiguous()
    vox_table = aligned(vox_table.to(dtype).contiguous())
    ray_feat = aligned(pad_columns(ray_feat.to(dtype),
                                   lay["c_rp"]).contiguous())
    cells, pos = cells.to(torch.int32).contiguous(), pos.float().contiguous()
    off = torch.empty((p,), dtype=torch.float32, device=cells.device)
    logit = torch.empty_like(off)
    ptrs = cuda.ptr_array([vox_table, cells, rays, pos, ray_feat,
                           *(w[k] for k in FORMAT.operands), n_rows, off,
                           logit])
    fn = cuda.bind("pair_decode", "idt_pair_decode", cuda.PTR,
                   *[cuda.I64] * 10, cuda.F32)
    cuda.check(fn(ptrs, p, c_vox, lay["c_rp"], multires, kp, slots, n_iter, g,
                  int(is_bf16), int(use_sigmoid), init_offset,
                  cuda.stream_ptr(cells.device)), "pair_decode")
    return off, logit


def pair_decode(vox_table, cells, pos, ray_feat, w,
                rays: Optional[torch.Tensor] = None, *,
                n_rows: Optional[torch.Tensor] = None, n_iter=2,
                init_offset=0.001, use_sigmoid=False):
    """Stage-1 per-pair decode (see :func:`pair_decode_plain`); kernel K6 on
    CUDA, which decodes only the rows below ``n_rows``. ``w``:
    :func:`prep_pair_decode_weights`. ``vox_table``: the unpadded table in
    any float dtype, cast and padded here to the operands'
    (``rows_operand``) for either branch."""
    vox_table = rows_operand(vox_table, w, FORMAT)
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


# -- training: K6 forward, the plain decode recomputed in the backward -------

def pair_decode_bwd_chunked(vox_table, cells, pos, ray_feat, w32, rays,
                            n_rows, g_off, g_logit, *, need, dtype, n_iter=2,
                            init_offset=0.001, use_sigmoid=False):
    """The gradients of :func:`pair_decode_plain` (at the f32 operands
    ``w32`` with the IEF's biases 2 and 3 rounded to ``dtype``, as the
    kernel takes them) for the cotangents ``g_off``, ``g_logit``, taken by
    autograd of the decode recomputed over chunks of
    :data:`TRAIN_CHUNK_ROWS` rows in order. ``need``: (vox_table, ray_feat,
    the weights) as booleans. Returns (d vox_table, d ray_feat, {weight:
    gradient}), None where not needed.

    Only the rows that carry a gradient are recomputed: those below the row
    count whose cotangents are not both 0 (a row with zero cotangents adds
    exact zeros to every gradient). Finding them takes one host sync, the
    span ``sync.pair_rows``. The dense layout's empty slots and the
    ``global`` mode's pad rows, most of the rows, all name one cell of an
    image and are left out.

    A chunk's voxel and ray rows are gathered as leaves of its own graph.
    Their gradients go back onto f32 tables by ``ops/segment.py::
    segment_sum_``, two launches a table a chunk: the live rows are sorted
    once, by (chunk, cell) and by (chunk, ray), and each chunk's rows are
    summed by key in an order that sort fixes, with no atomics. Every sum
    runs in f32 in chunk order, so that the result is the same bits run to
    run."""
    need_vox, need_ray, need_w = need
    p = cells.shape[0]
    keep = (g_off != 0) | (g_logit != 0)
    if n_rows is not None:
        keep &= torch.arange(p, device=cells.device) < n_rows
    with profiling.span("sync.pair_rows"):
        live = keep.nonzero()[:, 0]
    chunk = max(1, TRAIN_CHUNK_ROWS)
    pair_decode_bwd_chunked.rows += live.shape[0]
    pair_decode_bwd_chunked.chunks += -(-live.shape[0] // chunk)
    cells_l = cells[live].long()
    rays_l = live // _dense_slots(p, ray_feat.shape[0]) if rays is None \
        else rays[live].long()
    d_vox = torch.zeros(vox_table.shape, dtype=torch.float32,
                        device=vox_table.device) if need_vox else None
    d_ray = torch.zeros(ray_feat.shape, dtype=torch.float32,
                        device=ray_feat.device) if need_ray else None
    # one sort a table a step: each chunk's order and segments
    vox_plan = segment.chunk_sort(cells_l, chunk, vox_table.shape[0]) \
        if need_vox else None
    ray_plan = segment.chunk_sort(rays_l, chunk, ray_feat.shape[0]) \
        if need_ray else None
    d_w = {k: torch.zeros_like(w32[k], dtype=torch.float32)
           for k in FORMAT.operands if need_w}
    for s in range(0, live.shape[0], chunk):
        r = live[s:s + chunk]
        cells_c, rays_c = cells_l[s:s + chunk], rays_l[s:s + chunk]
        with torch.enable_grad():
            vox_rows = vox_table[cells_c].detach().requires_grad_(need_vox)
            ray_rows = ray_feat[rays_c].detach().requires_grad_(need_ray)
            leaves = {k: w32[k].detach().requires_grad_(need_w)
                      for k in FORMAT.operands}
            w = round_biases({**leaves, "dims": w32["dims"]}, FORMAT, dtype)
            out = decode_rows(vox_rows, pos[r], ray_rows, w, None, n_iter,
                              init_offset, use_sigmoid, dtype)
            wanted = ([vox_rows] if need_vox else []) \
                + ([ray_rows] if need_ray else []) \
                + (list(leaves.values()) if need_w else [])
            grads = list(torch.autograd.grad(
                out, wanted, (g_off[r], g_logit[r]), allow_unused=True))
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, wanted)]
        for table, plan in ((d_vox, vox_plan), (d_ray, ray_plan)):
            if table is not None:
                keys, order = (t[s:s + chunk] for t in plan)
                segment.segment_sum_(table, grads.pop(0), keys, order)
        for k, g in zip(d_w, grads):
            d_w[k] += g
    return (None if d_vox is None else d_vox.to(vox_table.dtype),
            None if d_ray is None else d_ray.to(ray_feat.dtype),
            d_w or None)


pair_decode_bwd_chunked.rows = 0
pair_decode_bwd_chunked.chunks = 0


class PairDecodeTrain(torch.autograd.Function):
    """The training pair decode on the card: forward K6, backward
    :func:`pair_decode_bwd_chunked` (autograd of :func:`pair_decode_plain`
    recomputed from the same inputs and the f32 split operands), as the JAX
    package trains the ``global`` and dense modes through autograd of
    ``xla_pair_decode`` (K6 has no VJP there).

    Takes the f32 operands (:func:`pair_decode_weights` of the live
    parameters, never the serving cache) and casts them inside, so that
    their gradients reach the f32 parameters unrounded. Saves only the
    inputs. Returns d vox_table, d ray_feat and every operand's gradient;
    cells, pos, rays and the row count are geometry and get none."""

    @staticmethod
    def forward(ctx, opts, vox_table, cells, pos, ray_feat, rays, n_rows,
                *ops):
        dtype, dims, n_iter, init_offset, use_sigmoid = opts
        w32 = dict(zip(FORMAT.operands, ops), dims=dims)
        with profiling.span("pair_decode.forward"):
            out = pair_decode(vox_table, cells, pos, ray_feat,
                              cast_operands(w32, FORMAT, dtype), rays,
                              n_rows=n_rows, n_iter=n_iter,
                              init_offset=init_offset,
                              use_sigmoid=use_sigmoid)
        ctx.opts = opts
        ctx.save_for_backward(vox_table, cells, pos, ray_feat, rays, n_rows,
                              *ops)
        return out

    @staticmethod
    def backward(ctx, g_off, g_logit):
        dtype, dims, n_iter, init_offset, use_sigmoid = ctx.opts
        vox_table, cells, pos, ray_feat, rays, n_rows, *ops = \
            ctx.saved_tensors
        need = ctx.needs_input_grad
        with profiling.span("pair_decode.backward"):
            d_vox, d_ray, d_w = pair_decode_bwd_chunked(
                vox_table, cells, pos, ray_feat,
                dict(zip(FORMAT.operands, ops), dims=dims), rays, n_rows,
                g_off, g_logit, need=(need[1], need[4], any(need[7:])),
                dtype=dtype,
                n_iter=n_iter, init_offset=init_offset,
                use_sigmoid=use_sigmoid)
        return (None, d_vox, None, None, d_ray, None, None,
                *(d_w[k] if d_w and n else None
                  for k, n in zip(FORMAT.operands, need[7:])))


def pair_decode_train(vox_table, cells, pos, ray_feat, w32, rays=None, *,
                      dtype, n_rows=None, n_iter=2, init_offset=0.001,
                      use_sigmoid=False):
    """Differentiable pair decode of a ``global`` or dense training step.

    ``w32``: the f32 operands from live parameters
    (:func:`pair_decode_weights`). CPU tensors take plain autograd through
    :func:`pair_decode_plain`; CUDA tensors take :class:`PairDecodeTrain`
    (K6 forward, the chunked plain recompute backward), with no fallback,
    at the kernel's widths: the operands and the table are padded here,
    under autograd, which drops the pads' gradients."""
    kw = dict(n_rows=n_rows, n_iter=n_iter, init_offset=init_offset,
              use_sigmoid=use_sigmoid)
    if cells.device.type == "cpu":
        return pair_decode_plain(vox_table, cells, pos, ray_feat,
                                 round_biases(w32, FORMAT, dtype), rays,
                                 dtype=dtype, **kw)
    w32 = pad_operands(w32, FORMAT)
    vox_table = pad_columns(vox_table, w32["dims"][0])
    return PairDecodeTrain.apply(
        (dtype, w32["dims"], n_iter, init_offset, use_sigmoid),
        vox_table, cells, pos, ray_feat, rays, n_rows,
        *(w32[k] for k in FORMAT.operands))
